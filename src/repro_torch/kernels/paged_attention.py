"""Paged decode attention on the card: the wrapper of ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``. The
kernel's design and what bounds it are described at the top of the ``.cu``
file; its plain version is ``ref.paged_attention_ref``, which ``ops``
dispatches to for CPU tensors. This wrapper takes CUDA tensors only: it
launches the kernel or raises.

``paged_attention.launches`` counts the launches of this process, so a run
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
        _fn = _build.bind("paged_attention", "repro_paged_attention",
                          [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                          + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return _fn


def _check(q, k_pages, v_pages, page_table, lengths):
    _build.check_tensors("paged_attention", 16, q=q, k_pages=k_pages, v_pages=v_pages,
                         page_table=page_table, lengths=lengths)
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel: dtype {q.dtype} not supported")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention kernel: q, k_pages and v_pages differ in dtype")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention kernel: page_table and lengths must be int32")
    b, h, hd = q.shape
    _, page, kvh, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(f"paged_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {hd} not in {_HEAD_DIMS}")
    if h % kvh:
        raise ValueError(f"paged_attention kernel: {h} heads not a multiple of {kvh} KV heads")
    if page_table.dim() != 2 or page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"paged_attention kernel: page_table {tuple(page_table.shape)}, "
                         f"lengths {tuple(lengths.shape)} for batch {b}")


def paged_attention(q, k_pages, v_pages, page_table, lengths, *, softcap: float = 0.0):
    """q: (B, H, hd); k/v_pages: (P, page, KV, hd); page_table: (B, max_pages)
    int32; lengths: (B,) int32 -> (B, H, hd) in q's dtype.

    Every table entry of a page below ceil(lengths[b] / page) must be a valid
    pool page; entries past it are never read."""
    _check(q, k_pages, v_pages, page_table, lengths)
    fn = _kernel()
    b, h, hd = q.shape
    _, page, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    # a stream of another device than the current one makes the launch fail
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, h, kvh, hd, page, page_table.shape[1], float(softcap), hd ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on_error("paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
