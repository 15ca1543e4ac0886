"""Public kernel entry points, dispatched on the tensors' device.

CUDA tensors go to the hand-written Hopper kernel, which is built at first
use and raises if it cannot build or launch. CPU tensors go to the plain
PyTorch version in ``ref``; that is the only way the plain version is
reached from here. Importing this module builds nothing.
"""
from __future__ import annotations

from . import paged_attention as _paged
from .ref import paged_attention_ref


def paged_attention(q, k_pages, v_pages, page_table, lengths, *, softcap: float = 0.0):
    """q: (B, H, hd); k/v_pages: (P, page, KV, hd); page_table: (B, max_pages)
    int32; lengths: (B,) int32 -> (B, H, hd)."""
    if q.is_cuda:
        return _paged.paged_attention(q, k_pages, v_pages, page_table, lengths,
                                      softcap=softcap)
    return paged_attention_ref(q, k_pages, v_pages, page_table, lengths, softcap=softcap)
