"""Per-device cost of a PyTorch program, counted as it runs: the role of
``repro/launch/hlo_cost.py``, without an HLO to parse.

``CostMode`` is a ``TorchDispatchMode``: every ATen operator (and every
``repro_torch`` kernel operator) that runs under it is counted once, from
its inputs' and outputs' shapes. Run the program on fake tensors
(``FakeTensorMode``, ``launch/specs.py``) and nothing is allocated or
computed; run it on real tensors and it runs as usual. The totals:

  * ``flops``: matrix-unit work only, as JAX's count takes ``dot`` and
    ``convolution`` only: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, the
    convolutions and PyTorch's fused attention where they run, by
    ``torch.utils.flop_counter``'s formulas; each kernel operator by its
    ``cost`` formula (``kernels/flash_attention.py``, whose formula also
    charges ``flash_attention_lse``, ``flash_attention_bwd.py``,
    ``paged_attention.py``, ``flush_score.py``). Elementwise work is left
    out, as in JAX.
  * ``memory_bytes``: a proxy for device-memory traffic at the granularity
    of the operators that materialise a tensor: every operator's output
    bytes, plus the operands a matmul or a collective reads. A view or
    alias writes nothing. A slice write is credited with the slice
    (``copy_`` into a view: the view's bytes) and a scatter with its
    updates (``index_put``, ``scatter``, ``index_copy`` ...), not the
    buffer, as ``tests/test_hlo_cost_model.py`` fixes for JAX. A kernel
    operator counts its formula's bytes. The paged kernel's bytes depend
    on ``lengths``: read from the tensor on a real call; on a fake tensor,
    which has no values, every row's whole table (the formula's worst
    case).
  * ``collective_bytes`` and ``collective_counts`` by kind (all-gather,
    reduce-scatter, all-reduce, all-to-all, collective-permute), from the
    c10d operators DTensor and ``distributed/collectives.py`` issue: the
    payload is the collective's output, as JAX's (an all-gather's output
    holds the gather factor, an all-reduce's is its operand). A collective
    over a group of one rank moves nothing and is not counted, as GSPMD
    emits none on a mesh axis of size 1.

**Per device.** A DTensor operator is not counted: the mode hands it to
DTensor, which runs the operator on each rank's local shard, and that local
operator is what the mode counts. DTensor's sharding propagation runs the
operator once more at the global shape on fake tensors to learn the output's
metadata; operators called from the propagator are not counted either. So a
(16, 16)-sharded matmul counts one device's product, once.

**No loops to multiply.** Eager PyTorch executes every layer and every
remat recompute, so each is counted as it runs (JAX's count multiplies a
scan body by its trip count).

**No bf16 correction.** JAX's dry-run halves its CPU-HLO bytes
(``BF16_CANONICALIZATION_CORRECTION``) because its CPU backend rewrites
bf16 to f32. A fake tensor keeps the dtype the program declares, so the
bytes here are the program's own.

``breakdown=True`` also keeps the totals by operator and by module path:
the chain of ``repro_torch`` functions on the Python stack at the
operator (``models.transformer.forward > models.layers.multihead_attention``),
the counterpart of HLO's ``op_name`` (``benchmarks/collective_breakdown.py``
prints it). ``live_bytes``/``peak_bytes`` follow the outputs the mode saw
allocated and not yet freed.
"""
from __future__ import annotations

import os
import sys
import time
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import (flash_attention, flash_attention_bwd, flush_score,
                                  paged_attention)

COLLECTIVES = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
               "collective-permute")
_COLLECTIVE_NAMES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
                     ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"), ("permute", "collective-permute"),
                     ("send", "collective-permute"))
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
aten = torch.ops.aten
# operand positions a matmul-class operator reads (others: every tensor input)
_MATMUL_OPERANDS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2),
                    aten.baddbmm: (1, 2), aten.convolution: (0, 1), aten._convolution: (0, 1)}
# in-place buffer updates: the argument whose bytes the write is credited with
_UPDATE_ARG = {aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
               aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3, aten.scatter_add_: 3,
               aten.scatter_reduce: 3, aten.scatter_reduce_: 3, aten.index_copy: 3,
               aten.index_copy_: 3, aten.index_add: 3, aten.index_add_: 3,
               aten.slice_scatter: 1, aten.select_scatter: 1, aten.masked_scatter_: 2}
_NO_WRITE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided}
_PROPAGATOR = os.path.join("distributed", "tensor", "_sharding_prop.py")
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_SKIP_FRAMES = (os.path.abspath(__file__), os.path.join(_PACKAGE, "kernels", "ops.py"))


def nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or a list or tuple of them)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _storages(tensors) -> set:
    out = set()
    for t in tensors:
        try:
            out.add(t.untyped_storage()._cdata)
        except (RuntimeError, NotImplementedError):    # a tensor with no storage
            pass
    return out


def collective_kind(func) -> str | None:
    """The JAX kind of a c10d operator, None for any other operator."""
    if func.namespace not in _COLLECTIVE_NS:
        return None
    name = func.__name__
    return next((kind for key, kind in _COLLECTIVE_NAMES if key in name), None)


def _group(args) -> tuple[str, int]:
    """(name, size) of the process group a c10d operator runs over: the
    functional ones take its name, the others the group."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    leaves = tree_leaves(args)
    groups = [a for a in leaves if isinstance(a, dist.ProcessGroup)]
    if groups:
        return groups[0].group_name, groups[0].size()
    names = [a for a in leaves if isinstance(a, str)]     # the group name comes last
    if names:
        return names[-1], _resolve_process_group(names[-1]).size()
    return "", dist.get_world_size()


def kernel_cost(func, args) -> dict | None:
    """The cost formula of a ``repro_torch`` kernel operator's call."""
    if func.namespace != "repro_torch":
        return None
    name = func.__name__.split(".")[0]
    if name in ("flash_attention", "flash_attention_lse"):
        q, k, _, causal, window, _, q_offset = args
        return flash_attention.cost(tuple(q.shape), tuple(k.shape), q.element_size(),
                                    causal=causal, window=window, q_offset=q_offset)
    if name == "flash_attention_backward":
        q, k, *_, causal, window, _, q_offset = args
        return flash_attention_bwd.cost(tuple(q.shape), tuple(k.shape), q.element_size(),
                                        causal=causal, window=window, q_offset=q_offset)
    if name == "paged_attention":
        q, pages, _, table, lengths, _ = args
        lens = None if isinstance(lengths, FakeTensor) else lengths.tolist()
        return paged_attention.cost(tuple(q.shape), tuple(pages.shape), tuple(table.shape),
                                    q.element_size(), lens)
    if name == "flush_scores":
        return flush_score.cost(*args[0].shape)
    raise ValueError(f"no cost formula for the kernel operator {func}")


class CostMode(TorchDispatchMode):
    """Counts the operators run under it; see the module docstring. Read
    ``totals()`` after the ``with`` block."""

    def __init__(self, *, breakdown: bool = False):
        super().__init__()
        self.breakdown = breakdown
        self.flops = 0
        self.memory_bytes = 0
        self.collective_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.collective_counts = dict.fromkeys(COLLECTIVES, 0)
        self.kernel_calls: dict[str, int] = defaultdict(int)
        self.by_op: dict[str, list] = defaultdict(lambda: [0, 0, 0])     # flops, bytes, coll
        self.by_path: dict[str, list] = defaultdict(lambda: [0, 0, 0])
        self.coll_by_path: dict[tuple, int] = defaultdict(int)
        self.collective_by_group: dict[str, int] = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it on the local shards, counted then
        out = func(*args, **kwargs)
        path = self._stack()
        if path is not None:
            self._count(func, args, kwargs, out, path)
        return out

    def _stack(self) -> str | None:
        """None inside DTensor's sharding propagation (a global-shape
        rehearsal on fake tensors), else the module path ('' unless
        ``breakdown``)."""
        chain = []
        f = sys._getframe(2)
        while f is not None:
            name = f.f_code.co_filename
            if name.endswith(_PROPAGATOR):
                return None
            if self.breakdown and name.startswith(_PACKAGE) and name not in _SKIP_FRAMES:
                mod = name[len(_PACKAGE):-3].replace(os.sep, ".")
                chain.append(f"{mod}.{f.f_code.co_name}")
            f = f.f_back
        return " > ".join(reversed(chain))

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def _count(self, func, args, kwargs, out, path: str) -> None:
        packet = func.overloadpacket
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        flops = mem = coll = 0
        kind = collective_kind(func)
        known = kernel_cost(func, args)
        if known is not None:
            flops, mem = known["flops"], known["bytes"]
            self.kernel_calls[func.__name__.split(".")[0]] += 1
        elif kind is not None:
            group, size = _group(args)
            if size == 1:           # a group of one rank moves nothing
                return
            coll = nbytes(args[0]) if func.namespace == "c10d" else nbytes(outs)
            self.collective_bytes[kind] += coll
            self.collective_counts[kind] += 1
            self.collective_by_group[group] += coll
            mem = nbytes(ins) + coll
            if self.breakdown:
                self.coll_by_path[(kind, path)] += coll
        else:
            if packet in flop_registry:
                flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
                reads = _MATMUL_OPERANDS.get(packet)
                mem += (nbytes([args[i] for i in reads]) if reads is not None
                        else nbytes(ins))
            mem += self._written(func, packet, args, ins, outs)
        self.flops += flops
        self.memory_bytes += mem
        if self.breakdown:
            for table, key in ((self.by_op, str(packet)), (self.by_path, path or "<top>")):
                row = table[key]
                row[0] += flops
                row[1] += mem
                row[2] += coll

    def _written(self, func, packet, args, ins, outs) -> int:
        """Bytes the operator writes: its new outputs, a slice write's
        slice, a scatter's updates; nothing for a view or an ``empty``."""
        if packet in _UPDATE_ARG:
            i = _UPDATE_ARG[packet]
            return nbytes(args[i]) if i < len(args) else 0
        if packet in _NO_WRITE:
            self._track(outs)
            return 0
        in_place = any(r.alias_info is not None and r.alias_info.is_write
                       for r in func._schema.returns)
        if in_place:
            return nbytes(outs)
        shared = _storages(ins)
        fresh = [t for t in outs if not _storages([t]) & shared]
        self._track(fresh)
        return nbytes(fresh)

    def _track(self, tensors) -> None:
        for t in tensors:
            n = t.numel() * t.element_size()
            self.live_bytes += n
            weakref.finalize(t, self._release, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def totals(self) -> dict:
        out = {"flops": self.flops, "memory_bytes": self.memory_bytes,
               "collective_bytes": dict(self.collective_bytes),
               "collective_counts": dict(self.collective_counts),
               "collective_total": sum(self.collective_bytes.values()),
               "kernel_calls": dict(self.kernel_calls), "peak_live_bytes": self.peak_bytes}
        if self.breakdown:
            out["by_op"] = {k: tuple(v) for k, v in self.by_op.items()}
            out["by_path"] = {k: tuple(v) for k, v in self.by_path.items()}
            out["collectives_by_path"] = dict(self.coll_by_path)
        return out


def analyze(fn, *args, breakdown: bool = False, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run under a ``CostMode``: its totals, with
    ``trace_s`` (the run's wall time) and ``result``."""
    mode = CostMode(breakdown=breakdown)
    t0 = time.perf_counter()
    with mode:
        result = fn(*args, **kwargs)
    return {**mode.totals(), "trace_s": time.perf_counter() - t0, "result": result}
