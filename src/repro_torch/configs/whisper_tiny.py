"""whisper-tiny [audio] — enc-dec, conv frontend stubbed (precomputed frames).

4L decoder (+4L encoder) d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.
[arXiv:2212.04356; unverified]. Decode shapes use extended sinusoidal
positions (the real model caps targets at 448 tokens — noted in DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    act="gelu",
    encoder_layers=4,
    encoder_seq=1500,
    rope_theta=0.0,          # sinusoidal absolute positions, not RoPE
    norm_eps=1e-5,
)
