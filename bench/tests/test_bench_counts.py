"""The frozen counts against values worked out by hand at small shapes,
and the attention + MoE family's at the published sizes."""
from __future__ import annotations

import bench_small  # noqa: F401  (the import path)
import common
import counts
from counts import moe_lm

SZ = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
      "moe_experts": 4, "moe_topk": 2, "moe_d_ff": 3, "vocab": 10, "tie_embeddings": False,
      "qk_norm": False}


def test_attention_counts():
    assert counts.causal_pairs(4) == 10
    assert counts.flash_fwd_flops(1, 2, 4, 4) == 4 * 2 * 4 * 10
    assert counts.flash_bwd_flops(3, 2, 4, 4) == 10 * 3 * 2 * 4 * 10


def test_parameter_counts():
    # attention 2*8*8 + 2*8*4, router 8*4, top-2 of 3*8*3
    assert moe_lm.layer_matmul_params(SZ) == 128 + 64 + 32 + 144
    assert moe_lm.active_params(SZ) == 2 * 368 + 80


def test_bounds():
    flops = 6 * moe_lm.active_params(SZ) * 2 * 4 + 3 * counts.flash_fwd_flops(2, 2, 4, 4) * 2
    assert moe_lm.train_step_flops(SZ, 2, 4) == flops


def test_granite_and_olmoe_at_published_sizes():
    g = {"n_layers": 24, "d_model": 1024, "n_heads": 16, "n_kv_heads": 8, "head_dim": 64,
         "moe_experts": 32, "moe_topk": 8, "moe_d_ff": 512, "vocab": 49155,
         "tie_embeddings": True}
    fam = counts.family(common.load_json("configs", "granite-moe-1b-a400m"))
    assert fam.active_params(g) == 428_608_512
    assert round(fam.train_step_flops(g, 8, 4096) / 1e12, 2) == 104.06
