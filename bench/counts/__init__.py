"""Frozen operation counts, from shapes alone, and the peak they are read
against: NVIDIA H100 SXM, dense bfloat16 989 TFLOP/s (the data sheet's
rate at the 700 W limit; a run prints the card's ``power.limit`` beside
its numbers).

The sizes are a configuration file's ``port`` section; nothing here reads
the program's own cost formulas.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12


def causal_pairs(s: int) -> int:
    """(query, key) pairs of causal attention over s positions."""
    return s * (s + 1) // 2


def flash_fwd_flops(b: int, h: int, hd: int, s: int) -> int:
    """QK^T and PV over the causal pairs."""
    return 4 * b * h * hd * causal_pairs(s)


def flash_bwd_flops(b: int, h: int, hd: int, s: int) -> int:
    """The backward's five products (S and dP formed again, dV, dK, dQ)."""
    return 10 * b * h * hd * causal_pairs(s)


def layer_matmul_params(sz: dict) -> int:
    """Parameters a token multiplies by in one block: the attention
    projections, the router and its top-k experts."""
    d, h, kv, hd = sz["d_model"], sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    attn = 2 * d * h * hd + 2 * d * kv * hd
    return attn + d * sz["moe_experts"] + sz["moe_topk"] * 3 * d * sz["moe_d_ff"]


def active_params(sz: dict) -> int:
    """Every block's ``layer_matmul_params`` and the output head."""
    return sz["n_layers"] * layer_matmul_params(sz) + sz["d_model"] * sz["vocab"]


def train_step_flops(sz: dict, batch: int, seq: int) -> int:
    """6 x active parameters x tokens, plus causal attention's forward and
    backward (3 x the forward's 4 B H hd pairs) in every layer."""
    attn = 3 * flash_fwd_flops(batch, sz["n_heads"], sz["head_dim"], seq) * sz["n_layers"]
    return 6 * active_params(sz) * batch * seq + attn
