"""Public kernel entry points, dispatched on the tensors' device.

CUDA tensors go to the hand-written Hopper kernel, which is built at first
use and raises if it cannot build or launch. CPU tensors go to the plain
PyTorch version in ``ref``; that is the only way the plain version is
reached from here. Importing this module builds nothing.

Flash attention has a gradient: ``FlashAttention`` runs the kernel (or, on
CPU tensors, the plain version) forward and ``ref.flash_attention_bwd``
backward. The JAX package has no backward kernel (its training gradient is
XLA's autodiff of the jnp attention), so the backward is PyTorch ops.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import flash_attention as _flash
from . import flush_score as _flush
from . import paged_attention as _paged
from .ref import (flash_attention_bwd, flash_attention_ref, flush_scores_ref,
                  paged_attention_ref)


class FlashAttention(torch.autograd.Function):
    """Forward: the Hopper flash kernel on CUDA tensors (it launches or
    raises; a remat recompute launches it again), the plain version on CPU
    tensors. Saves q, k, v and the output. Backward:
    ``ref.flash_attention_bwd``, f32 math in chunks of keys, under the
    profiler range ``flash_attention_backward``. Under ``torch.no_grad`` it is the forward
    alone, so serving launches the kernel exactly as a direct call."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        out = (_flash.flash_attention(q, k, v, **kw) if q.is_cuda
               else flash_attention_ref(q, k, v, **kw))
        ctx.save_for_backward(q, k, v, out)
        ctx.kw = kw
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_backward"):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd), with a
    gradient (``FlashAttention``)."""
    return FlashAttention.apply(q, k, v, causal, window, softcap, q_offset)


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
