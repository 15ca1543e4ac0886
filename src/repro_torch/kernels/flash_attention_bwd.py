"""Flash attention backward on the card: the wrapper of ``csrc/flash_attention_bwd.cu``.

No TPU kernel is replaced: the JAX package differentiates its jnp attention
with XLA and has no backward kernel. This kernel computes that gradient for
the forward kernel of ``flash_attention.py``, from the row log-sum-exps the
forward saved (``flash_attention_lse``). The ``.cu`` file says what bounds
it and describes its three kernels (D = rowsum(do * out), dK/dV over the
query tiles of each key tile, dQ over the key tiles of each query tile) and
its two designs: ``wgmma`` for bf16 at head_dim 64, 120 and 128 (Hopper's
warpgroup tensor-core products, fed by TMA rings from a producer warp, two
consumer warpgroups a block), ``simt`` (f32 FMAs) for fp32 and for bf16 at
head_dim 16 and 32. Its plain version is ``ref.flash_attention_bwd``, which ``ops``
dispatches to for CPU tensors. This wrapper takes CUDA tensors only: it
launches the kernels or raises.

``flash_attention_bwd.launches`` counts the calls of this process (each
launches the three kernels) and ``flash_attention_bwd.launches_by_design``
splits them by design. ``cost`` is the work a call needs: the bound of
``chip_smoke.py`` and the count of ``launch/cost.py`` both read it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import _DTYPES, _check as _check_forward, pairs

DESIGNS = ("simt", "wgmma")          # the entry point's design codes 0 and 1
_fn = None
_design_fn = None


def _kernel():
    global _fn, _design_fn
    if _fn is None:
        _fn = _build.bind("flash_attention_bwd", "repro_flash_attention_bwd",
                          [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        _design_fn = _build.bind("flash_attention_bwd", "repro_flash_attention_bwd_design",
                                 [ctypes.c_int, ctypes.c_int])
    return _fn


def cost(q_shape, kv_shape, itemsize: int, *, causal: bool = True, window: int = 0,
         q_offset: int = 0) -> dict:
    """The work one call needs, from shapes: ``flops`` = 10 B H hd x
    ``pairs`` (the five products of a (query, key) pair: q.k, do.v, p^T do,
    ds^T q, ds k; 2 each a pair and head dim); ``bytes`` = q, k, v, out and
    do read and dq, dk, dv written once, ``itemsize`` bytes an element, and
    lse read and D written, f32 a row."""
    b, sq, h, hd = q_shape
    skv, kvh = kv_shape[1], kv_shape[2]
    return {"flops": 10 * b * h * hd * pairs(sq, skv, causal, window, q_offset),
            "bytes": itemsize * (6 * b * sq * h * hd + 4 * b * skv * kvh * hd)
            + 2 * 4 * b * h * sq}


def _check(q, k, v, out, lse, do, window, q_offset):
    _check_forward(q, k, v, window, q_offset)
    _build.check_tensors("flash_attention_bwd", 16, q=q, out=out, lse=lse, do=do)
    b, sq, h, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape or out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd kernel: out {tuple(out.shape)} {out.dtype} and "
                         f"do {tuple(do.shape)} {do.dtype} must be q's {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd kernel: lse {tuple(lse.shape)} {lse.dtype}, "
                         f"wants {(b, h, sq)} float32")
    if max(b, k.shape[2]) >= 2 ** 16:
        raise ValueError("flash_attention_bwd kernel: batch or KV heads past the grid's 65,535")


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """Gradients (dq, dk, dv) of attention at (q, k, v), whose forward gave
    ``out`` and ``lse`` (``flash_attention_lse``), for the output gradient
    ``do``; shaped and typed as q, k, v. q, out, do: (B, Sq, H, hd); k/v:
    (B, Skv, KV, hd); lse: (B, H, Sq) f32."""
    _check(q, k, v, out, lse, do, window, q_offset)
    fn = _kernel()
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kind = DESIGNS[_design_fn(_DTYPES[q.dtype], hd)]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             dsum.data_ptr(), b, sq, skv, h, kvh, hd, int(causal), int(window),
             float(softcap), int(q_offset), hd ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on_error("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_design[kind] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_design = dict.fromkeys(DESIGNS, 0)
