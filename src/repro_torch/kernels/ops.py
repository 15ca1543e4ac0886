"""Public kernel entry points, each a PyTorch operator of the ``repro_torch``
namespace (``torch.ops.repro_torch.*``), dispatched on the tensors' device.

Each operator has three implementations:
  * CUDA: the hand-written Hopper kernel's wrapper, which builds the kernel
    at first use, launches it (and counts the launch) or raises;
  * CPU: the plain PyTorch version in ``ref``, the only way the plain
    version is reached from here;
  * fake: the output's shape and dtype, so the kernels trace under
    ``FakeTensorMode`` (shape-only dry runs, ``launch/dryrun.py``) as a
    Pallas call traces under ``jax.eval_shape``, and a counting dispatch
    mode (``launch/cost.py``) sees each call as one operator, which it
    charges by the kernel's ``cost`` formula.
The operators are defined with ``torch.library.Library`` and ``impl``
(``torch.library.custom_op`` adds more host time per call). Importing this
module registers them and builds nothing.

Flash attention has a gradient: ``FlashAttention`` runs
``flash_attention_lse`` forward (the output and each row's log-sum-exp)
and ``flash_attention_backward`` backward, on CUDA tensors the Hopper
backward kernel (``flash_attention_bwd.py``: ``wgmma`` products fed by
TMA rings for bf16 at head_dim 64, 120 and 128, ``simt`` otherwise). The
JAX package has no backward kernel (its training gradient is XLA's
autodiff of the jnp attention); the port's computes the same gradient.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import flash_attention as _flash
from . import flash_attention_bwd as _flash_bwd
from . import flush_score as _flush
from . import paged_attention as _paged
from . import ref

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int window, "
            "float softcap, int q_offset) -> Tensor")
_LIB.define("flash_attention_lse(Tensor q, Tensor k, Tensor v, bool causal, int window, "
            "float softcap, int q_offset) -> (Tensor, Tensor)")
_LIB.define("flash_attention_backward(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
            "Tensor do, bool causal, int window, float softcap, int q_offset) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("paged_attention(Tensor q, Tensor k_pages, Tensor v_pages, Tensor page_table, "
            "Tensor lengths, float softcap) -> Tensor")
_LIB.define("flush_scores(Tensor hits, Tensor clock, Tensor valid) -> Tensor")


def _flash_cuda(q, k, v, causal, window, softcap, q_offset):
    return _flash.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                  q_offset=q_offset)


def _flash_cpu(q, k, v, causal, window, softcap, q_offset):
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                   q_offset=q_offset)


def _flash_lse_cuda(q, k, v, causal, window, softcap, q_offset):
    return _flash.flash_attention_lse(q, k, v, causal=causal, window=window, softcap=softcap,
                                      q_offset=q_offset)


def _flash_lse_cpu(q, k, v, causal, window, softcap, q_offset):
    return ref.flash_attention_lse(q, k, v, causal=causal, window=window, softcap=softcap,
                                   q_offset=q_offset)


def _flash_bwd_cuda(q, k, v, out, lse, do, causal, window, softcap, q_offset):
    return _flash_bwd.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window,
                                          softcap=softcap, q_offset=q_offset)


def _flash_bwd_cpu(q, k, v, out, lse, do, causal, window, softcap, q_offset):
    # the plain version recomputes each row's max and sum: it does not take
    # lse; its gradients come back contiguous, as the kernel's
    grads = ref.flash_attention_bwd(q, k, v, out, do, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset)
    return tuple(g.contiguous() for g in grads)


def _paged_cuda(q, k_pages, v_pages, page_table, lengths, softcap):
    return _paged.paged_attention(q, k_pages, v_pages, page_table, lengths, softcap=softcap)


def _paged_cpu(q, k_pages, v_pages, page_table, lengths, softcap):
    return ref.paged_attention_ref(q, k_pages, v_pages, page_table, lengths, softcap=softcap)


def _flush_cpu(hits, clock, valid):
    return ref.flush_scores_ref(hits, clock, valid)


_LIB.impl("flash_attention", _flash_cuda, "CUDA")
_LIB.impl("flash_attention", _flash_cpu, "CPU")
_LIB.impl("flash_attention_lse", _flash_lse_cuda, "CUDA")
_LIB.impl("flash_attention_lse", _flash_lse_cpu, "CPU")
_LIB.impl("flash_attention_backward", _flash_bwd_cuda, "CUDA")
_LIB.impl("flash_attention_backward", _flash_bwd_cpu, "CPU")
_LIB.impl("paged_attention", _paged_cuda, "CUDA")
_LIB.impl("paged_attention", _paged_cpu, "CPU")
_LIB.impl("flush_scores", _flush.flush_scores, "CUDA")
_LIB.impl("flush_scores", _flush_cpu, "CPU")


@torch.library.register_fake("repro_torch::flash_attention", lib=_LIB)
def _flash_fake(q, k, v, causal, window, softcap, q_offset):
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::flash_attention_lse", lib=_LIB)
def _flash_lse_fake(q, k, v, causal, window, softcap, q_offset):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


@torch.library.register_fake("repro_torch::flash_attention_backward", lib=_LIB)
def _flash_bwd_fake(q, k, v, out, lse, do, causal, window, softcap, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@torch.library.register_fake("repro_torch::paged_attention", lib=_LIB)
def _paged_fake(q, k_pages, v_pages, page_table, lengths, softcap):
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::flush_scores", lib=_LIB)
def _flush_fake(hits, clock, valid):
    return torch.empty_like(hits)


class FlashAttention(torch.autograd.Function):
    """Forward: the ``flash_attention_lse`` operator (on CUDA tensors the
    Hopper kernel, which launches or raises; a remat recompute launches it
    again; on CPU tensors the plain version). Saves q, k, v, the output and
    the rows' log-sum-exps. Backward: the ``flash_attention_backward``
    operator (on CUDA tensors the Hopper backward kernel, ``wgmma`` or
    ``simt`` by the input, which launches or raises; on CPU tensors
    ``ref.flash_attention_bwd``), under the profiler
    range ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal, window, softcap,
                                                             q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, q_offset)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_backward"):
            dq, dk, dv = torch.ops.repro_torch.flash_attention_backward(
                q, k, v, out, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd). Where a
    gradient is recorded, through ``FlashAttention``; else (serving, under
    ``torch.no_grad``) the ``flash_attention`` operator alone, which stores
    no log-sum-exp."""
    args = (causal, int(window), float(softcap), int(q_offset))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, *args)
    return torch.ops.repro_torch.flash_attention(q, k, v, *args)


def flush_scores(hits, clock, valid):
    """hits: (num_sets, set_size) int32; clock: (num_sets,) int32; valid:
    (num_sets, set_size) bool -> (num_sets, set_size) int32, -1 invalid."""
    return torch.ops.repro_torch.flush_scores(hits, clock, valid)


def paged_attention(q, k_pages, v_pages, page_table, lengths, *, softcap: float = 0.0):
    """q: (B, H, hd); k/v_pages: (P, page, KV, hd); page_table: (B, max_pages)
    int32; lengths: (B,) int32 -> (B, H, hd)."""
    return torch.ops.repro_torch.paged_attention(q, k_pages, v_pages, page_table, lengths,
                                                 float(softcap))
