"""Public kernel entry points, dispatched on the tensors' device.

CUDA tensors go to the hand-written Hopper kernel, which is built at first
use and raises if it cannot build or launch. CPU tensors go to the plain
PyTorch version in ``ref``; that is the only way the plain version is
reached from here. Importing this module builds nothing.
"""
from __future__ import annotations

from . import flash_attention as _flash
from . import flush_score as _flush
from . import paged_attention as _paged
from .ref import flash_attention_ref, flush_scores_ref, paged_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd)."""
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    if q.is_cuda:
        return _flash.flash_attention(q, k, v, **kw)
    return flash_attention_ref(q, k, v, **kw)


def flush_scores(hits, clock, valid):
    """hits: (num_sets, set_size) int32; clock: (num_sets,) int32; valid:
    (num_sets, set_size) bool -> (num_sets, set_size) int32, -1 invalid."""
    if hits.is_cuda:
        return _flush.flush_scores(hits, clock, valid)
    return flush_scores_ref(hits, clock, valid)


def paged_attention(q, k_pages, v_pages, page_table, lengths, *, softcap: float = 0.0):
    """q: (B, H, hd); k/v_pages: (P, page, KV, hd); page_table: (B, max_pages)
    int32; lengths: (B,) int32 -> (B, H, hd)."""
    if q.is_cuda:
        return _paged.paged_attention(q, k_pages, v_pages, page_table, lengths,
                                      softcap=softcap)
    return paged_attention_ref(q, k_pages, v_pages, page_table, lengths, softcap=softcap)
