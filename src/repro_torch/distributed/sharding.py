"""Sharding rules: parameter and cache trees -> ``PartitionSpec`` trees, and
those specs as DTensor placements on a ``DeviceMesh``; the port's twin of
``repro/distributed/sharding.py``.

Strategy, as in JAX:
  * FSDP (ZeRO-3) over ``data`` (over ``("pod", "data")`` on the two-pod
    mesh) on the non-TP dim of every matmul weight;
  * tensor parallelism over ``model``: attention heads, d_ff, d_inner, vocab;
  * MoE experts over ``data`` (EP), their d_ff over ``model``, matching the
    ``local_map`` placements inside ``moe_ffn``;
  * small vectors (norms, biases, A_log, ...) replicated.

Rules are path-based (``tree.map_with_path``'s keys, JAX's ``_path_str``)
so they survive nesting; a stacked leaf (leading ``n_blocks`` dim) gets a
``None`` prepended. A spec entry naming several axes, ``("pod", "data")``,
becomes ``Shard(d)`` on each of those mesh dims; DTensor then cuts dim d
over the mesh dims in mesh order, pod major, as JAX's ``NamedSharding``
does for a tuple entry.
"""
from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import mesh_shape
from repro_torch.tree import map_with_path, tree_map


class PartitionSpec:
    """One entry per tensor dim: None (replicated), an axis name, or a tuple
    of axis names (major to minor). A one-name tuple is stored as the name,
    as ``jax.sharding.PartitionSpec`` stores it. Not a tuple itself, so that
    a tree of specs has the specs as its leaves."""

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshAxes:
    """Logical roles of mesh axes. fsdp may span several physical axes."""

    fsdp: tuple[str, ...] = ("data",)
    tp: str = "model"
    ep: str = "data"

    @classmethod
    def for_mesh(cls, mesh) -> "MeshAxes":
        if "pod" in mesh_shape(mesh):
            return cls(fsdp=("pod", "data"))
        return cls()


def _rules(ax: MeshAxes):
    """(path regex, spec). First match wins. ``F`` = fsdp axes, ``T`` = tp."""
    F, T, E = ax.fsdp, ax.tp, ax.ep
    return [
        (r"embed$", P(T, F)),                     # (V, D): vocab over TP
        (r"lm_head$", P(F, T)),
        (r"\b(wq|wk|wv)$", P(F, T)),              # (D, H*hd)
        (r"\bwo$", P(T, F)),                      # (H*hd, D)
        (r"\b(w_gate|w_up)$", P(F, T)),           # dense mlp (D, F)
        (r"\bw_down$", P(T, F)),                  # (F, D)
        (r"moe/router$", P()),                    # (D, E) small
        (r"moe/(w_gate|w_up)$", P(E, None, T)),   # (E, D, F)
        (r"moe/w_down$", P(E, T, None)),          # (E, F, D)
        (r"\b(in_x|in_z|in_dt)$", P(F, T)),       # mamba: d_inner/heads over TP
        (r"\bin_bc$", P(F, None)),                # shared B/C: replicated cols
        (r"\bconv_x_w$", P(None, T)),
        (r"\bconv_x_b$", P(T)),
        (r"\bout_proj$", P(T, F)),                # (d_inner, D)
        (r"", P()),                               # norms, scalars, the rest
    ]


def _spec_for(path_s: str, ndim: int, rules) -> PartitionSpec:
    for pat, spec in rules:
        if re.search(pat, path_s):
            if len(spec) > ndim:      # a rule for a 2-d weight hit a 1-d leaf etc.
                spec = P(*spec[-ndim:]) if ndim else P()
            pad = ndim - len(spec)
            return P(*([None] * pad), *spec) if pad else spec
    return P()


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _fix_divisibility(spec: PartitionSpec, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Drop (or shrink) axis assignments that don't divide the dim evenly
    (e.g. whisper's vocab 51865 can't shard 16 ways)."""
    sizes = mesh_shape(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        kept, size = [], 1
        for a in _axes(entry):
            if shape[i] % (size * sizes[a]) == 0:
                kept.append(a)
                size *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def param_specs(params: Any, mesh, *, fsdp: bool = True) -> Any:
    """PartitionSpec tree for a parameter tree (leaves: anything with
    ``ndim`` and ``shape``, a meta tensor too).

    ``fsdp=False`` (the serving layout): weights stay TP-sharded over
    ``model`` but are replicated over the data axes, so a decode step
    gathers no weight. Training keeps ZeRO-3 FSDP."""
    ax = MeshAxes.for_mesh(mesh)
    rules = _rules(ax)

    def leaf_spec(path, leaf):
        spec = _spec_for(path, leaf.ndim, rules)
        if not fsdp:
            spec = P(*[None if entry is not None and set(_axes(entry)) <= set(ax.fsdp)
                       else entry for entry in spec])
        return _fix_divisibility(spec, tuple(leaf.shape), mesh)

    return map_with_path(leaf_spec, params)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes: ``("pod", "data")`` on the two-pod mesh."""
    return MeshAxes.for_mesh(mesh).fsdp


def dp_size(mesh) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= sizes[a]
    return n


def data_spec(mesh, batch: int) -> PartitionSpec:
    """Token batch spec: batch over every data-parallel axis that divides."""
    dp = dp_axes(mesh)
    size = dp_size(mesh)
    if batch % size == 0 and size > 1:
        return P(dp)
    if batch % mesh_shape(mesh)[dp[-1]] == 0:
        return P(dp[-1])
    return P()


def cache_specs(cache: Any, mesh, batch: int) -> Any:
    """Decode-cache specs. Rank-based rules over stacked leaves:

      (nb, B, S, KV, hd)  attn KV      -> batch over dp, seq over tp
      (nb, B, S)          kpos         -> same
      (nb, B, H, N, hd)   ssm state    -> batch over dp, heads over tp
      (nb, B, cw-1, C)    conv state   -> batch over dp, channels over tp
      (B,)                lengths      -> replicated

    For a batch of 1 the KV sequence dim takes every mesh axis instead (all
    cards cooperate on one sequence)."""
    dp, dp_n = dp_axes(mesh), dp_size(mesh)
    tp = MeshAxes.for_mesh(mesh).tp
    tp_size = mesh_shape(mesh)[tp]
    batch_ax = dp if (batch % dp_n == 0 and dp_n > 1) else None

    def leaf_spec(name, leaf):
        nd = leaf.ndim
        if name.endswith("lengths"):
            return P()
        seq_ax: Any = tp if batch_ax is not None else (*dp, tp)
        seq_div = tp_size if batch_ax is not None else dp_n * tp_size
        if re.search(r"(^|/)(k|v)$", name) and nd == 5:
            if leaf.shape[2] % seq_div == 0:
                return P(None, batch_ax, seq_ax, None, None)
            return P(None, batch_ax, None, None, None)
        if name.endswith("kpos") and nd == 3:
            if leaf.shape[2] % seq_div == 0:
                return P(None, batch_ax, seq_ax)
            return P(None, batch_ax, None)
        if name.endswith("ssm") and nd == 5:
            return P(None, batch_ax, tp if leaf.shape[2] % tp_size == 0 else None, None, None)
        if name.endswith("conv_x") and nd == 4:
            return P(None, batch_ax, None, tp if leaf.shape[3] % tp_size == 0 else None)
        if name.endswith("conv_bc") and nd == 4:
            return P(None, batch_ax, None, None)
        if re.search(r"cross", name) and nd == 5:
            return P(None, batch_ax, None, None, None)
        # fallback: batch over dp when a dim matches
        return P(*[batch_ax if leaf.shape[i] == batch and i < 2 else None
                   for i in range(nd)])

    return map_with_path(leaf_spec, cache)


def placements(spec: PartitionSpec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where the spec names that axis at tensor dim d, else
    ``Replicate()``. The axes of one entry must come in mesh order (pod
    before data): DTensor cuts a dim over several mesh dims major to minor
    in mesh order, and JAX in the entry's order."""
    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(a) for a in _axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: the axes {entry} are not in the mesh's order {names}")
        for i in dims:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} shards two dims")
            out[i] = Shard(d)
    return out


def cut_axes(t: DTensor, dim: int):
    """The spec entry of ``t``'s dim ``dim``: the names of the mesh axes
    that cut it, in mesh order (None for none)."""
    names = list(mesh_shape(t.device_mesh))
    return tuple(a for a, p in zip(names, t.placements) if p == Shard(dim)) or None


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with its spec's
    placements. Every rank holds the same full leaf (drawn from one seed or
    read from one checkpoint); each keeps its own slice, with no
    communication (``src_data_rank=None``). None stays None."""
    flat = {}
    map_with_path(flat.__setitem__, specs)
    return map_with_path(lambda key, leaf: distribute_tensor(
        leaf, mesh, placements(flat[key], mesh), src_data_rank=None), tree)


def constrain(x, mesh, spec: PartitionSpec):
    """``x`` redistributed to ``spec`` on ``mesh``, the port's
    ``with_sharding_constraint``. A plain tensor stays as it is, and so
    does a DTensor that already has the placements when autograd does not
    record it: a redistribute to the same placements moves nothing and
    costs host time, where under autograd it also pins the gradient's
    placements on the way back."""
    if not isinstance(x, DTensor):
        return x
    pl = placements(spec, mesh)
    if tuple(pl) == x.placements and not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return x.redistribute(mesh, pl)


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, but nestable: it restores the
    setting it found (DTensor's own resets it to off on exit)."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def mesh_context(mesh):
    """Where a mesh is given, DTensor's implicit replication: a plain tensor
    met by a DTensor op (an ``arange``, positions, a mask) counts as
    replicated on the mesh, as an unsharded array does under GSPMD."""
    return _implicit_replication() if mesh is not None else contextlib.nullcontext()


def replicate(x, mesh):
    """A plain tensor that every rank holds in full as a replicated DTensor
    (no communication); a DTensor stays as it is."""
    if isinstance(x, DTensor):
        return x
    return distribute_tensor(x, mesh, [Replicate()] * len(mesh_shape(mesh)), src_data_rank=None)


def replicated(fn, mesh, *args, **kwargs):
    """``fn`` over the whole of its inputs on every rank, for a batch too
    small to cut (the MoE's single-row decode): DTensor leaves of ``args``
    are gathered (``full_tensor``, whose gradient flows back to the shards),
    and the tensors ``fn`` returns come back as replicated DTensors. Without
    a mesh, ``fn(*args, **kwargs)``."""
    if mesh is None:
        return fn(*args, **kwargs)
    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    out = fn(*(tree_map(full, a) for a in args), **kwargs)
    rep = [Replicate()] * len(mesh_shape(mesh))
    return tree_map(lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
                    if isinstance(t, torch.Tensor) else t, out)


def like_placements(g, p):
    """A DTensor ``g`` (a gradient) in the placements of ``p`` (its
    parameter), a ``Partial`` sum reduced into them, as GSPMD reduces a
    gradient into its parameter's sharding; anything else as it is."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def whole(x):
    """A DTensor's whole value as a plain tensor, the same on every rank (a
    gather); a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local_part(x):
    """This rank's shard of a DTensor as a plain tensor; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is made contiguous on its way back. A DTensor
    ``view`` in the backward of a projection fails on a local gradient laid
    out transposed (as the attention backward's dk comes), where plain
    PyTorch would copy."""
    return _ContiguousGrad.apply(x)


class _GradInPlacements(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and g.placements != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_in_placements(x):
    """``x``, whose gradient is redistributed to ``x``'s own placements on
    its way back (a plain tensor as it is). DTensor hands a matmul's input
    gradient back in the placements its backward strategy picks, which a
    view in the backward may not take: merged attention heads (B, S, H*hd)
    replicated over ``model``, their gradient cut over it, cannot be split
    back into H < 16 heads."""
    return _GradInPlacements.apply(x) if isinstance(x, DTensor) else x

