"""Frozen counts of the attention + MoE family (``reference/moe_lm.py``):
every layer the attention projections, the router and its top-k experts."""
from __future__ import annotations

from . import flash_fwd_flops


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
