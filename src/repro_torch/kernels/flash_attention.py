"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``. The
``.cu`` file holds two designs and says at its top what bounds each and why:
``wgmma`` (tensor cores, TMA-fed K/V) for bf16 at head_dim 64, 120 and 128,
and ``simt`` (f32 FMAs) for fp32 and for bf16 at head_dim 16 and 32. Its
plain version is ``ref.flash_attention_ref``, which ``ops`` dispatches to
for CPU tensors. This wrapper takes CUDA tensors only: it launches a kernel
or raises.

``flash_attention_lse`` launches the same kernel and also returns each
row's log-sum-exp, (B, H, Sq) f32, which the training path saves for the
backward kernel (``flash_attention_bwd``); serving calls ``flash_attention``,
which stores none.

``flash_attention.launches`` counts the launches of this process (through
either entry), and ``flash_attention.launches_by_design`` splits them by
design, so a run can show that its main path went through the kernel it
expects.

``cost`` is the work a call needs (``pairs`` of query and key the masks
leave valid): the bound of ``chip_smoke.py`` and the count of
``launch/cost.py`` both read it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 120, 128)
DESIGNS = ("simt", "wgmma")          # the entry point's design codes 0 and 1
_fn = None
_design_fn = None


def _kernel():
    global _fn, _design_fn
    if _fn is None:
        _fn = _build.bind("flash_attention", "repro_flash_attention",
                          [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        _design_fn = _build.bind("flash_attention", "repro_flash_attention_design",
                                 [ctypes.c_int, ctypes.c_int])
    return _fn


def pairs(sq: int, skv: int, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the masks leave valid: the work of one head.
    Query row i sits at position p = i + q_offset and sees keys
    max(0, p - window + 1) .. min(p, skv - 1) (either end open when its mask
    is off); counted row by row in closed form, so a 32k prefill needs no
    (Sq, Skv) mask."""
    p = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(p, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def cost(q_shape, kv_shape, itemsize: int, *, causal: bool = True, window: int = 0,
         q_offset: int = 0) -> dict:
    """The work one call needs, from shapes: ``flops`` = 4 B H hd x
    ``pairs`` (q.k and p.v, 2 each a pair and head dim); ``bytes`` = q, k, v
    read once and the output written once, ``itemsize`` bytes an element."""
    b, sq, h, hd = q_shape
    skv, kvh = kv_shape[1], kv_shape[2]
    return {"flops": 4 * b * h * hd * pairs(sq, skv, causal, window, q_offset),
            "bytes": itemsize * (2 * b * sq * h * hd + 2 * b * skv * kvh * hd)}


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


def _launch(q, k, v, causal, window, softcap, q_offset, lse):
    _check(q, k, v, window, q_offset)
    fn = _kernel()
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kind = DESIGNS[_design_fn(_DTYPES[q.dtype], hd)]      # the design the library launches
    if kind == "wgmma" and hd * q.element_size() % 16:
        # TMA takes row strides in multiples of 16 bytes
        raise ValueError(f"flash_attention kernel: a row of {hd} x {q.dtype} is not a "
                         "multiple of 16 bytes")
    out = torch.empty_like(q)
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), b, sq, skv, h, kvh, hd, int(causal),
             int(window), float(softcap), int(q_offset), hd ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on_error("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.launches_by_design[kind] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's dtype.

    Query row i sits at position i + q_offset; keys at 0 .. Skv-1."""
    return _launch(q, k, v, causal, window, softcap, q_offset, None)


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """``flash_attention``'s output and each row's log-sum-exp of its valid
    scores, (B, H, Sq) f32 in the natural base, +inf for a row with no valid
    key: what the backward kernel reads."""
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window, softcap, q_offset, lse), lse


flash_attention.launches = 0
flash_attention.launches_by_design = dict.fromkeys(DESIGNS, 0)
