"""Mixture-of-Experts FFN in PyTorch, mirroring ``repro/models/moe.py``:
top-k routing and a capacity-bounded dispatch.

Each expert gets a buffer of ``cap`` token rows (``_capacity``), the three
per-expert products run as batched matmuls over ``(E, cap, d)``, and the
combine gathers each kept assignment's row back. Every expert's buffer is
computed whatever its fill, as in JAX, so a decode step reads every expert's
weights.

An assignment's slot is JAX's: the running count of its expert over the
assignments in token-major order. JAX takes it from a cumsum down a one-hot
(T*k, E), which on the card is a scan of E lanes each T*k long; the port takes
it from one stable sort of the expert ids (its rank among its expert's
assignments, which the stable sort keeps in token-major order), so the same
assignments drop. Kept slots are unique, so both gathers (token rows into
the buffer, expert rows back to the assignments) have a backward that is a
gather through the inverse map (``_GatherRows``), with no accumulating
scatter.

A layer may hold some of the experts (``cfg.held_experts`` from
``cfg.moe_first_expert``, one rank's share under expert parallelism run
without the exchange): the router, its top-k and the aux losses stay over
all ``moe_experts``, and so does the capacity; the products run on the held
experts' slots only, and an assignment to an expert the layer does not hold
adds nothing, as a dropped one. A shared expert (``cfg.moe_shared_d_ff``)
runs on every token beside them and is added to their output.

Over a mesh, ``moe_ffn`` runs ``moe_local`` under ``local_map`` (JAX's
``shard_map``): expert parallelism ships each expert's rows to the rank
that owns it with an all-to-all over ``data``; tensor parallelism sums the
d_ff shards' outputs over ``model`` after the token combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (experts_to_owners, pmean, psum,
                                                 rows_to_sources, scale_grad)
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, placements, replicate, replicated, whole
from repro_torch.launch.mesh import mesh_shape
from .layers import init_normal, mlp, profiled


def init_moe(generator, cfg: ModelConfig, device=None) -> dict:
    """The router (over all ``moe_experts``) in float32, the held experts
    and the shared expert (``"shared"``, where the config has one) in the
    config dtype, with JAX's layout and scales (N(0,1) * d**-0.5 in,
    * d_ff**-0.5 out)."""
    d, e, f = cfg.d_model, cfg.held_experts, cfg.moe_d_ff
    dt = getattr(torch, cfg.dtype)
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {
        "router": init_normal((d, cfg.moe_experts), generator, device, s_in, torch.float32),
        "w_gate": init_normal((e, d, f), generator, device, s_in, dt),
        "w_up": init_normal((e, d, f), generator, device, s_in, dt),
        "w_down": init_normal((e, f, d), generator, device, s_out, dt),
    }
    if cfg.moe_shared_d_ff:
        fs = cfg.moe_shared_d_ff
        p["shared"] = {"w_gate": init_normal((d, fs), generator, device, s_in, dt),
                       "w_up": init_normal((d, fs), generator, device, s_in, dt),
                       "w_down": init_normal((fs, d), generator, device, fs ** -0.5, dt)}
    return p


def _capacity(tokens: int, cfg: ModelConfig, factor: float | None = None) -> int:
    """Rows of each expert's buffer: T*k/E * factor, rounded up to 8, at least 8."""
    f = cfg.moe_capacity_factor if factor is None else factor
    c = int(tokens * cfg.moe_topk / cfg.moe_experts * f)
    return max(8, -(-c // 8) * 8)


def route(x, params, cfg: ModelConfig, stats_groups=()):
    """Router of ``moe_local``. x: (T, d). Returns the renormalised top-k
    weights (T, k) f32, the expert ids (T, k) and the aux losses, their
    statistics averaged over ``stats_groups`` (the axes that shard the
    tokens), so that the losses are those of all the tokens."""
    e, k_top = cfg.moe_experts, cfg.moe_topk
    logits = x.float() @ params["router"]                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k_top, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)                                            # (E,)
    ce = F.one_hot(idx, e).float().sum(1).mean(dim=0) / k_top
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    if stats_groups:
        me, ce, z = (pmean(t, stats_groups) for t in (me, ce, z))
    return w, idx, {"lb": e * torch.sum(me * ce), "z": z}


def dispatch(idx, n_experts: int, cap: int):
    """Capacity dispatch of the (T, k) expert ids: an assignment's slot is
    the running count of its expert over the T*k assignments in token-major
    order, its rank in a stable sort of the ids less its expert's start.
    Returns (keep (T*k,) bool: slot < cap, dest (T*k,): expert * cap + slot
    where kept, else the overflow slot E * cap). No host sync."""
    e_flat = idx.reshape(-1)
    ids, order = torch.sort(e_flat, stable=True)
    # an id's first index in the sorted ids is its expert's start
    rank = torch.arange(e_flat.numel(), device=idx.device) - torch.searchsorted(ids, ids)
    pos = torch.empty_like(rank).scatter_(0, order, rank)           # back to token-major
    keep = pos < cap
    return keep, torch.where(keep, pos.add(e_flat, alpha=cap), n_experts * cap)


def slot_sources(dest, n_slots: int):
    """The inverse of ``dispatch``'s ``dest``: each of the ``n_slots`` slots'
    assignment, the assignments' count where the slot is empty. Kept slots
    are unique; the overflow slot is cut off unread."""
    n = dest.numel()
    src = torch.full((n_slots + 1,), n, dtype=torch.long, device=dest.device)
    return src.scatter(0, dest, torch.arange(n, device=dest.device))[:n_slots]


def _padded(x):
    """``x`` (n, d) with a zero row n appended."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)


class _GatherRows(torch.autograd.Function):
    """``_padded(src)[index]``, whose backward is ``_padded(grad)[inverse]``
    summed over each ``group`` of consecutive rows: ``inverse`` lists, for
    each row of ``src``, the ``group`` output rows that read it, the output's
    row count (its zero row) where fewer do. Exact where every output row
    reads one row of ``src`` or the zero row, which holds of both MoE
    gathers."""

    @staticmethod
    def forward(ctx, src, index, inverse, group):
        ctx.save_for_backward(inverse)
        ctx.group = group
        return _padded(src)[index]

    @staticmethod
    def backward(ctx, g):
        inverse, = ctx.saved_tensors
        rows = _padded(g)[inverse]
        if ctx.group > 1:
            rows = rows.view(-1, ctx.group, rows.shape[1]).sum(1)
        return rows, None, None, None


def _gather_rows(src, index, inverse, group: int = 1):
    """``_padded(src)[index]``: through ``_GatherRows`` where autograd
    records, else directly (serving, where each op call's host cost
    counts)."""
    if torch.is_grad_enabled():
        return _GatherRows.apply(src, index, inverse, group)
    return _padded(src)[index]


def moe_local(x, params, cfg: ModelConfig, *, ep_group=None, tp_group=None, ep_size: int = 1,
              capacity_factor: float | None = None, stats_group=()):
    """Per-shard MoE math. x: (B, S, d) local. Returns (y (B, S, d), {"lb",
    "z"}). With ``ep_group`` (``ep_size`` ranks, each holding E/ep_size
    experts) the (E, C, d) buffer goes to the experts' owners as (E/ep,
    C*ep, d) and back; with ``tp_group`` (each rank a d_ff slice of its
    experts) the combined (T, d) output is summed over it; the aux losses'
    statistics are averaged over ``stats_group`` (a tuple of groups)."""
    b, s, d = x.shape
    e, k_top = cfg.moe_experts, cfg.moe_topk
    t = b * s
    xf = x.reshape(t, d)
    w, idx, aux = route(xf, params, cfg, stats_group)

    with profiled("moe.routed"):
        cap = _capacity(t, cfg, capacity_factor)
        _, dest = dispatch(idx, e, cap)
        src = slot_sources(dest, e * cap)
        held = cfg.held_experts
        if held != e:
            # the held experts' slots; an assignment to another expert reads
            # and writes the overflow slot, as a dropped one
            lo = cfg.moe_first_expert * cap
            src = src[lo:lo + held * cap]
            dest = dest - lo
            dest = torch.where((dest >= 0) & (dest < held * cap), dest, held * cap)
        buf = src // k_top                                            # slot -> token, t where empty

        xg = _gather_rows(xf, buf, dest, k_top).reshape(held, cap, d)  # (E, C, d)
        ep = ep_group is not None and ep_size > 1
        if ep:
            xg = experts_to_owners(xg, ep_group, ep_size)            # (E/D, C*D, d)
        act = F.silu if cfg.act == "silu" else (lambda v: F.gelu(v, approximate="tanh"))
        h = act(torch.bmm(xg, params["w_gate"])) * torch.bmm(xg, params["w_up"])
        y = torch.bmm(h, params["w_down"])
        if ep:
            y = rows_to_sources(y, ep_group, ep_size)                 # (E, C, d)
        y = y.reshape(held * cap, d)

        out_tk = _gather_rows(y, dest, src)                           # (T*K, d), 0 if dropped
        out = (out_tk.reshape(t, k_top, d) * w[..., None].to(y.dtype)).sum(dim=1)
        if tp_group is not None:
            # after the token combine: a (T, d) sum, not the (E, C, d) buffer's
            out = psum(out, (tp_group,))
    return out.reshape(b, s, d).to(x.dtype), aux


def shared_expert(x, params, cfg: ModelConfig):
    """The shared expert's SwiGLU (GeGLU under ``cfg.act`` "gelu") on every
    token of x (B, S, d)."""
    with profiled("moe.shared"):
        return mlp(x, params, cfg.act)


def _grad_placements(spec, mesh) -> list:
    """``shard_map``'s transpose of a replicated input: the ranks' cotangents
    are summed, so each replicated mesh dim of the input takes ``Partial``."""
    return [Partial() if isinstance(pl, Replicate) else pl for pl in placements(spec, mesh)]


def moe_ffn(x, params, cfg: ModelConfig, mesh=None, dp_axes: tuple[str, ...] | None = None,
            ep_axis: str = "data", tp_axis: str = "model"):
    """MoE FFN. x: (B, S, d). Returns (y, {"lb", "z"}): the routed experts'
    output (``routed_ffn``), plus the shared expert's where the config has
    one."""
    y, aux = routed_ffn(x, params, cfg, mesh, dp_axes, ep_axis, tp_axis)
    if cfg.moe_shared_d_ff:
        y = y + shared_expert(x, params["shared"], cfg)
    return y, aux


def routed_ffn(x, params, cfg: ModelConfig, mesh=None, dp_axes: tuple[str, ...] | None = None,
               ep_axis: str = "data", tp_axis: str = "model"):
    """The routed experts of the MoE FFN. x: (B, S, d). Returns (y, {"lb", "z"}).

    With a ``mesh`` (a ``DeviceMesh`` with named dims) it follows JAX's
    modes under ``local_map``: "tp" (``cfg.moe_parallel``) gives every rank
    a d_ff/TP slice of every expert and its own tokens, one (T, d) sum over
    ``model``; "ep" gives each rank E/D experts (all-to-all over ``data``)
    and sums d_ff over ``model`` where TP > 1. "tp" falls back to "ep" when
    TP is 1 or does not divide ``moe_d_ff``; EP falls back to 1 when D does
    not divide E. A batch the data-parallel axes do not divide takes the
    local math on every rank (all of it replicated). Plain ``x`` and params
    count as replicated, and then y and the losses come back plain."""
    sizes = {} if mesh is None else mesh_shape(mesh)
    if ep_axis not in sizes:
        return moe_local(x, params, cfg)
    plain = not isinstance(x, DTensor)
    x = replicate(x, mesh)
    keys = ("router", "w_gate", "w_up", "w_down")
    params = {k: replicate(params[k], mesh) for k in keys}
    dp_axes = dp_axes or sharding.dp_axes(mesh)
    dp_n = 1
    for a in dp_axes:
        dp_n *= sizes[a]
    n_all = 1
    for n in sizes.values():
        n_all *= n
    if x.shape[0] % dp_n != 0:
        # a batch too small to shard (single-sequence decode): every rank
        # runs the whole of it, as GSPMD's plain path
        y, aux = replicated(moe_local, mesh, x, params, cfg)
        return (whole(y), {k: whole(v) for k, v in aux.items()}) if plain else (y, aux)
    tp_size = sizes.get(tp_axis, 1)
    mode = cfg.moe_parallel
    if mode == "tp" and (tp_size <= 1 or cfg.moe_d_ff % tp_size != 0):
        mode = "ep"
    ep_size = sizes[ep_axis]
    if cfg.moe_experts % ep_size != 0:
        ep_size = 1   # pure TP when E doesn't divide the axis
    ep_size = ep_size if mode == "ep" else 1
    ep_ax = ep_axis if ep_size > 1 else None
    tp_ax = tp_axis if tp_size > 1 else None
    specs = {"x": P(dp_axes, None, None), "router": P(),
             "w_gate": P(ep_ax, None, tp_axis), "w_up": P(ep_ax, None, tp_axis),
             "w_down": P(ep_ax, tp_axis, None)}
    groups = {a: mesh.get_group(a) for a in sizes}
    out_scale = n_all / dp_n          # an output replicated over the non-dp ranks

    def fn(xl, router, w_gate, w_up, w_down):
        y, aux = moe_local(xl, {"router": router, "w_gate": w_gate, "w_up": w_up,
                                "w_down": w_down}, cfg,
                           ep_group=groups[ep_ax] if ep_ax else None,
                           tp_group=groups[tp_ax] if tp_ax else None, ep_size=ep_size,
                           stats_group=tuple(groups[a] for a in dp_axes))
        return (scale_grad(y, 1 / out_scale), scale_grad(aux["lb"], 1 / n_all),
                scale_grad(aux["z"], 1 / n_all))

    names = ("x", *keys)
    rep = placements(P(), mesh)
    y, lb, z = local_map(
        fn, out_placements=(placements(specs["x"], mesh), rep, rep),
        in_placements=tuple(placements(specs[k], mesh) for k in names),
        in_grad_placements=tuple(_grad_placements(specs[k], mesh) for k in names),
        device_mesh=mesh, redistribute_inputs=True)(x, *(params[k] for k in keys))
    if plain:
        return whole(y), {"lb": whole(lb), "z": whole(z)}
    return y, {"lb": lb, "z": z}
