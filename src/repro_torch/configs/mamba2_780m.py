"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128. [arXiv:2405.21060;
unverified]. expand=2 => d_inner=3072, head_dim=64 => 48 SSM heads.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    block=(LayerSpec(kind="mamba", ffn="none"),),
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    norm_eps=1e-5,
)
