"""olmoe-1b-7b [moe] — 64 experts top-8. [arXiv:2409.02060; hf]

16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert) vocab=50304.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    block=(LayerSpec(kind="attn", ffn="moe"),),
    moe_experts=64,
    moe_topk=8,
    moe_d_ff=1024,
    qk_norm=True,
    moe_parallel="tp",  # §Perf: 11x fewer collective bytes than EP all-to-all on 16x16
)
