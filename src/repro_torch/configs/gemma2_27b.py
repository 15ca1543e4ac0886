"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000. [arXiv:2408.00118; hf]
Block of 2: sliding-window(4096) layer then full-attention layer; GeGLU;
attention softcap 50, final-logit softcap 30; pre+post norms.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    block=(LayerSpec(kind="attn", ffn="mlp", window=4096),
           LayerSpec(kind="attn", ffn="mlp", window=0)),
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
)
