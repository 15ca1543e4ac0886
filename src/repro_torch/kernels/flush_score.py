"""GClock flush scores on the card: the wrapper of ``csrc/flush_score.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flush_score.py``. The
kernel's design and what bounds it are described at the top of the ``.cu``
file; its plain version is ``ref.flush_scores_ref``, which ``ops``
dispatches to for CPU tensors. This wrapper takes CUDA tensors only: it
launches the kernel or raises.

``flush_scores.launches`` counts the launches of this process, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_SET_SIZE = 256      # one block holds whole sets
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("flush_score", "repro_flush_scores",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return _fn


def _check(hits, clock, valid):
    _build.check_tensors("flush_scores", hits=hits, clock=clock, valid=valid)
    if hits.dtype != torch.int32 or clock.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"flush_scores kernel: hits {hits.dtype}, clock {clock.dtype}, "
                        f"valid {valid.dtype}; wants int32, int32, bool")
    if hits.dim() != 2 or valid.shape != hits.shape or clock.shape != hits.shape[:1]:
        raise ValueError(f"flush_scores kernel: shapes hits {tuple(hits.shape)}, "
                         f"clock {tuple(clock.shape)}, valid {tuple(valid.shape)}")
    if not 1 <= hits.shape[1] <= MAX_SET_SIZE:
        raise ValueError(f"flush_scores kernel: set_size {hits.shape[1]} not in "
                         f"1..{MAX_SET_SIZE}")
    if hits.numel() >= 2 ** 31:
        raise ValueError("flush_scores kernel: more than 2**31 slots")


def flush_scores(hits, clock, valid):
    """hits: (num_sets, set_size) int32; clock: (num_sets,) int32; valid:
    (num_sets, set_size) bool -> flush scores (num_sets, set_size) int32,
    -1 for an invalid slot."""
    _check(hits, clock, valid)
    fn = _kernel()
    ns, ss = hits.shape
    out = torch.empty_like(hits)
    err = fn(hits.data_ptr(), clock.data_ptr(), valid.data_ptr(), out.data_ptr(), ns, ss,
             torch.cuda.current_stream(hits.device).cuda_stream)
    _build.raise_on_error("flush_score", err)
    flush_scores.launches += 1
    return out


flush_scores.launches = 0
