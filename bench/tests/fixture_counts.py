"""Frozen counts of the tests' family ``fixture_lm`` (``tests/fixture_lm.py``),
copied to ``counts/fixture_lm.py`` of a copy of the benchmark by
``test_bench_family.py``: each layer's attention projections, then its
spec's MLP or router and top-k experts."""
from __future__ import annotations

from . import flash_fwd_flops


def layer_matmul_params(sz: dict, l: int) -> int:
    """Parameters a token multiplies by in layer ``l``."""
    d, h, kv, hd = sz["d_model"], sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    attn = 2 * d * h * hd + 2 * d * kv * hd
    if sz["block"][l % len(sz["block"])]["ffn"] == "mlp":
        return attn + 3 * d * sz["d_ff"]
    return attn + d * sz["moe_experts"] + sz["moe_topk"] * 3 * d * sz["moe_d_ff"]


def active_params(sz: dict) -> int:
    """Every layer's ``layer_matmul_params`` and the output head."""
    layers = sum(layer_matmul_params(sz, l) for l in range(sz["n_layers"]))
    return layers + sz["d_model"] * sz["vocab"]


def train_step_flops(sz: dict, batch: int, seq: int) -> int:
    """6 x active parameters x tokens, plus causal attention's forward and
    backward in every layer."""
    attn = 3 * flash_fwd_flops(batch, sz["n_heads"], sz["head_dim"], seq) * sz["n_layers"]
    return 6 * active_params(sz) * batch * seq + attn
