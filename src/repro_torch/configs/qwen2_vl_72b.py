"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (frontend stubbed).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. [arXiv:2409.12191; hf]
The vision tower is a STUB: ``input_specs()`` supplies precomputed patch
embeddings (vis_tokens x d_model) prepended to the text sequence, plus the
(t, h, w) M-RoPE position ids. mrope_sections are half-dim section sizes
(16, 24, 24) summing to head_dim/2 = 64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    mrope_sections=(16, 24, 24),
    vis_tokens=1024,
    rope_theta=1.0e6,
)
