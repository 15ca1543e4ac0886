"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536. [arXiv:2403.19887; hf]
Block of 8 layers: attention at index 4, Mamba elsewhere; MoE FFN on odd
indices (1::2), dense FFN on even — the published period-8 layout.
"""
from .base import LayerSpec, ModelConfig

_BLOCK = tuple(
    LayerSpec(kind="attn" if i == 4 else "mamba",
              ffn="moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    block=_BLOCK,
    moe_experts=16,
    moe_topk=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    moe_parallel="tp",  # §Perf: expert-TP beats EP all-to-all on the 16x16 mesh
)
