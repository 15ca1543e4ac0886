"""Frozen counts of the Granite 4.0-H family (``reference/granite_hybrid.py``):
a period of Mamba2 and attention layers, each with a MoE of held experts
and a shared expert."""
from __future__ import annotations

from . import causal_pairs, flash_fwd_flops

SSD_CHUNK = 256        # the published mamba_chunk_size


def _kinds(sz: dict) -> list[str]:
    """Each layer's kind, ``"mamba"`` or ``"attn"``."""
    return [sz["block"][l % len(sz["block"])]["kind"] for l in range(sz["n_layers"])]


def mixer_params(sz: dict, kind: str) -> int:
    """Parameters a token multiplies by in a layer's mixer: Mamba2's in_proj
    (z, x, B, C, dt) and out_proj, or attention's four projections."""
    d = sz["d_model"]
    if kind == "mamba":
        di = sz["ssm_expand"] * d
        return d * (2 * di + 2 * sz["ssm_state"] + di // sz["ssm_head_dim"]) + di * d
    h, kv, hd = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    return 2 * d * h * hd + 2 * d * kv * hd


def moe_params(sz: dict) -> float:
    """Parameters a token multiplies by in a layer's MoE: the router, the
    shared expert, and the held experts at their expected share of a
    token's top-k, k * held / E experts."""
    d, e = sz["d_model"], sz["moe_experts"]
    held = sz.get("moe_held_experts") or e
    routed = sz["moe_topk"] * held / e * 3 * d * sz["moe_d_ff"]
    return d * e + 3 * d * sz["moe_shared_d_ff"] + routed


def active_params(sz: dict) -> int:
    """Every layer's mixer and MoE, and the output head."""
    layers = sum(mixer_params(sz, k) + moe_params(sz) for k in _kinds(sz))
    return round(layers) + sz["d_model"] * sz["vocab"]


def ssd_flops(sz: dict, batch: int, seq: int) -> int:
    """One Mamba2 layer's SSD products in the forward, in the chunked form
    at the published chunk: C.B over each chunk's causal pairs, the scores
    times x, each chunk's state and its read-out."""
    di = sz["ssm_expand"] * sz["d_model"]
    n = sz["ssm_state"]
    chunk = min(SSD_CHUNK, seq)
    pairs = seq // chunk * causal_pairs(chunk)
    return batch * (2 * pairs * n + 2 * pairs * di + 2 * 2 * seq * n * di)


def train_step_flops(sz: dict, batch: int, seq: int) -> int:
    """6 x active parameters x tokens, plus the attention layers' causal
    forward and backward (3 x the forward's 4 B H hd pairs) and the Mamba2
    layers' SSD products (3 x the forward's)."""
    kinds = _kinds(sz)
    attn = 3 * flash_fwd_flops(batch, sz["n_heads"], sz["head_dim"], seq) * kinds.count("attn")
    ssd = 3 * ssd_flops(sz, batch, seq) * kinds.count("mamba")
    return 6 * active_params(sz) * batch * seq + attn + ssd
