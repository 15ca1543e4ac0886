"""granite-4.0-h-small [hybrid] — Mamba2 + NoPE attention 9:1, MoE 72e top-10
with a shared expert, Granite's multipliers.

40L d_model=4096 32H (GQA kv=8, head_dim 128), no position encoding;
Mamba2 128 heads of 64 (d_inner 8192), state 128, one group, conv 4;
every layer a MoE of 72 experts of width 768, top-10, plus a shared expert
of width 1536; embeddings x 12, attention scores x 0.0078125, sublayer
outputs x 0.22 before each residual add, logits / 16; tied, vocab=100352,
eps 1e-5. Block of 10 layers: attention at index 5, Mamba2 elsewhere — the
published period. [hf:ibm-granite/granite-4.0-h-small]
"""
from .base import LayerSpec, ModelConfig

_BLOCK = tuple(LayerSpec(kind="attn" if i == 5 else "mamba", ffn="moe") for i in range(10))

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab=100352,
    head_dim=128,
    block=_BLOCK,
    rope_theta=0.0,
    moe_experts=72,
    moe_topk=10,
    moe_d_ff=768,
    moe_shared_d_ff=1536,
    moe_parallel="ep",
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_divisor=16.0,
    tie_embeddings=True,
    norm_eps=1e-5,
    max_seq=131072,
)
