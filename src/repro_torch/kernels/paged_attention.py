"""Paged decode attention on the card: the wrapper of ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``. The
kernel's design (split-K over pages, a ``cp.async`` ring, one combine) and
what bounds it are described at the top of the ``.cu`` file; its plain
version is ``ref.paged_attention_ref``, which ``ops`` dispatches to for CPU
tensors. This wrapper takes CUDA tensors only: it launches the kernel or
raises.

``_plan_splits`` cuts the page table into splits from the shapes alone:
``lengths`` is never read on the host, so a call can be captured in a CUDA
graph and replayed with new lengths.

Counters of this process, so a run can show that its main path went through
the kernel: ``paged_attention.launches`` (calls of this wrapper, one split
kernel each), ``paged_attention.combine_launches`` (the merge kernel, which
runs when a plan has more than one split) and ``paged_attention.splits``
(splits launched, summed over calls); ``paged_attention.last_plan`` is the
plan of the latest call.

``cost`` is the work a call needs: the bound of ``chip_smoke.py`` and the
count of ``launch/cost.py`` both read it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 120, 128)


# keys per tile, q heads per block, table entries a block keeps in shared
# memory: the kernel's geometry, read from its source, so the plan and the
# kernel cannot drift apart
TILE_KEYS, MAX_GROUP, MAX_SPLIT_PAGES = _build.kernel_constants(
    "paged_attention", "kTile", "kMaxGroup", "kMaxSplitPages")
BLOCKS_PER_SM = 2        # the plan's target of blocks per SM when the table is long
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("paged_attention", "repro_paged_attention",
                          [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                          + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return _fn


@functools.lru_cache(maxsize=256)
def _plan_splits(batch: int, kv_heads: int, group: int, max_pages: int, page: int,
                 sm_count: int) -> tuple[int, int]:
    """(pages per split, number of splits) for a table of ``max_pages`` pages.

    Whole pages per split, a whole number of the kernel's tiles where a page
    is shorter than a tile, at most ``MAX_SPLIT_PAGES``; as many splits as
    bring the blocks (splits x rows x KV heads x group chunks) to about
    ``BLOCKS_PER_SM`` per SM. The splits cover the table once, in order; the
    last may be shorter. Shapes only: no tensor is read."""
    base = _blocks(batch, kv_heads, group, 1)
    tile_pages = max(1, TILE_KEYS // page)
    want = max(1, -(-BLOCKS_PER_SM * sm_count // max(base, 1)))
    cap = MAX_SPLIT_PAGES // tile_pages * tile_pages
    per = max(tile_pages, max_pages // want // tile_pages * tile_pages)
    per = max(1, min(per, cap, max_pages))
    return per, max(1, -(-max_pages // per))


def _blocks(batch: int, kv_heads: int, group: int, n_splits: int) -> int:
    """Blocks of the split kernel's grid (split, KV head x group chunk, row)."""
    return n_splits * kv_heads * -(-group // MAX_GROUP) * batch


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cost(q_shape, pages_shape, table_shape, itemsize: int, lengths=None) -> dict:
    """The work one call needs, from shapes and the rows' key counts
    ``lengths`` (ints): ``bytes`` = the K and V rows of every row's keys
    read once, q read and the output written, the table entries of the
    whole pages holding those keys and the lengths (int32); ``flops`` =
    4 H hd x the keys (q.k and p.v). ``lengths`` None (a fake tensor has no
    values to read) counts every row's whole table, the most a call can
    need."""
    b, h, hd = q_shape
    _, page, kvh, _ = pages_shape
    if lengths is None:
        lengths = [table_shape[1] * page] * b
    keys = sum(int(n) for n in lengths)
    entries = sum(-(-int(n) // page) for n in lengths)
    return {"flops": 4 * h * hd * keys,
            "bytes": kv_bytes(lengths, kvh, hd, itemsize) + 2 * b * h * hd * itemsize
            + entries * 4 + b * 4}


def kv_bytes(lengths, kv_heads: int, head_dim: int, itemsize: int) -> int:
    """Bytes of the K and V rows of every row's ``lengths`` keys, read once."""
    return sum(int(n) for n in lengths) * kv_heads * head_dim * 2 * itemsize


def _check(q, k_pages, v_pages, page_table, lengths):
    # cp.async copies 16-byte chunks of K/V rows: with the pools 16-byte
    # aligned and (P, page, KV, hd) contiguous, every row is, since
    # kvh * hd * elem is a multiple of 16 for each supported hd and dtype
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
    max_pages = page_table.shape[1]
    per, n_splits = _plan_splits(b, kvh, h // kvh, max_pages, page, _sm_count(q.device.index))
    out = torch.empty_like(q)
    ml_ptr = acc_ptr = None
    if n_splits > 1:   # f32 partials of each (row, split, q head): (m, l), then acc
        n_ml = b * n_splits * h * 2
        part = torch.empty(n_ml + n_ml // 2 * hd, dtype=torch.float32, device=q.device)
        ml_ptr = part.data_ptr()
        acc_ptr = ml_ptr + 4 * n_ml
    q_scale = hd ** -0.5 * (1.0 if softcap else math.log2(math.e))
    # a stream of another device than the current one makes the launch fail
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), ml_ptr, acc_ptr,
             b, h, kvh, hd, page, max_pages, per, n_splits, float(softcap), q_scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on_error("paged_attention", err)
    paged_attention.launches += 1
    paged_attention.splits += n_splits
    if n_splits > 1:
        paged_attention.combine_launches += 1
    paged_attention.last_plan = {"pages_per_split": per, "splits": n_splits,
                                 "blocks": _blocks(b, kvh, h // kvh, n_splits)}
    return out


paged_attention.launches = 0
paged_attention.combine_launches = 0
paged_attention.splits = 0
paged_attention.last_plan = None
