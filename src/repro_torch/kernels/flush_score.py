"""GClock flush scores on the card: the wrapper of ``csrc/flush_score.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flush_score.py``. The
``.cu`` file holds two designs and says at its top what bounds each and why:
``set`` (a thread per set, the set size a template constant) for set sizes
1-16, and ``slot`` (a thread per slot) for 17-256. Its
plain version is ``ref.flush_scores_ref``, which ``ops`` dispatches to for
CPU tensors. This wrapper takes CUDA tensors only: it launches the kernel or
raises.

``flush_scores.launches`` counts the launches of this process, and
``flush_scores.launches_by_design`` splits them by design, so a run can
show that its main path went through the kernel it expects.

``cost`` is the work a call needs: the bound of ``chip_smoke.py`` and the
count of ``launch/cost.py`` both read it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_SET_SIZE = 256      # the slot design's block holds whole sets
DESIGNS = ("slot", "set")          # the entry point's design codes 0 and 1
_fn = None
_design_fn = None


def _kernel():
    global _fn, _design_fn
    if _fn is None:
        _fn = _build.bind("flush_score", "repro_flush_scores",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        _design_fn = _build.bind("flush_score", "repro_flush_scores_design", [ctypes.c_int])
    return _fn


def cost(num_sets: int, set_size: int) -> dict:
    """The work one call needs: ``bytes`` = hits (int32), valid (bool) and
    the scores (int32) of every slot, 9 bytes a slot, and the clock, 4
    bytes a set; ``flops`` 0 (integer compares, no floating point)."""
    return {"flops": 0, "bytes": num_sets * set_size * (4 + 1 + 4) + num_sets * 4}


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
    kind = DESIGNS[_design_fn(ss)]
    out = torch.empty_like(hits)
    err = fn(hits.data_ptr(), clock.data_ptr(), valid.data_ptr(), out.data_ptr(), ns, ss,
             torch.cuda.current_stream(hits.device).cuda_stream)
    _build.raise_on_error("flush_score", err)
    flush_scores.launches += 1
    flush_scores.launches_by_design[kind] += 1
    return out


flush_scores.launches = 0
flush_scores.launches_by_design = dict.fromkeys(DESIGNS, 0)
