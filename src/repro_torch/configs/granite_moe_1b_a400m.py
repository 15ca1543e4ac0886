"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert) vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    block=(LayerSpec(kind="attn", ffn="moe"),),
    moe_experts=32,
    moe_topk=8,
    moe_d_ff=512,
    tie_embeddings=True,
    moe_parallel="tp",  # §Perf: expert-TP beats EP all-to-all on the 16x16 mesh
)
