"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``. The
kernel's design and what bounds it are described at the top of the ``.cu``
file; its plain version is ``ref.flash_attention_ref``, which ``ops``
dispatches to for CPU tensors. This wrapper takes CUDA tensors only: it
launches the kernel or raises.

``flash_attention.launches`` counts the launches of this process, so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 120, 128)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("flash_attention", "repro_flash_attention",
                          [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    return _fn


def _check(q, k, v, window, q_offset):
    _build.check_tensors("flash_attention", 16, q=q, k=k, v=v)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel: dtype {q.dtype} not supported")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel: q, k and v differ in dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    bk, skv, kvh, hd_k = k.shape
    if bk != b or hd_k != hd:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "differ in batch or head_dim")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {hd} not in {_HEAD_DIMS}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention kernel: {h} heads not a multiple of {kvh} KV heads")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention kernel: window {window} and q_offset {q_offset} "
                         "must be >= 0")
    if max(sq, skv) + q_offset >= 2 ** 31:
        raise ValueError("flash_attention kernel: positions past int32")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's dtype.

    Query row i sits at position i + q_offset; keys at 0 .. Skv-1."""
    _check(q, k, v, window, q_offset)
    fn = _kernel()
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, skv, h, kvh, hd, int(causal), int(window), float(softcap),
             int(q_offset), hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on_error("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
