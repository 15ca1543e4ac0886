"""AdamW with global-norm clipping, a cosine schedule and an optional f32
master copy, mirroring ``repro/optim/adamw.py``.

Plain functions on the parameter tree (dicts and tuples of tensors, the
JAX tree's layout), under ``torch.no_grad``. Where JAX returns new arrays,
``adamw_update`` writes the new moments, master copy and parameters into
the tensors it was given and returns them in the same tree: at full size a
second copy of the state would not fit beside the first.

The tree may hold DTensors (params, moments and master copy of one leaf
with one placement, ``distributed.param_specs``): the clip norm is then
that of the whole tensors, one partial sum of squares reduced once over
the mesh, and each leaf's update runs on its local shard, the same
elementwise arithmetic.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.distributed.sharding import like_placements, local_part
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor               # 0-d int32
    m: Any
    v: Any
    master: Optional[Any] = None     # f32 weights when params are bf16


@torch.no_grad()
def adamw_init(params: Any, master_fp32: bool = True) -> AdamWState:
    """Zero moments (f32) with each leaf's placements where the params are
    DTensors; ``step`` a plain 0-d int32 tensor."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    master = None
    if master_fp32 and any(p.dtype != torch.float32 for p in tree_leaves(params)):
        master = tree_map(lambda p: p.float().clone(), params)
    first = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params), master=master)


def _sum_squares(g: DTensor) -> torch.Tensor:
    """This rank's share of the sum of squares of a DTensor with ``Shard``
    and ``Replicate`` placements: its shard's, divided by the number of
    ranks that hold the same shard, so that the sum over the mesh counts
    every element once."""
    copies = 1
    for n, pl in zip(g.device_mesh.shape, g.placements):
        copies *= n if isinstance(pl, Replicate) else 1
    return g.to_local().float().square().sum() / copies


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32. Over DTensors: a
    ``Partial`` sum of the ranks' shares (``_sum_squares``), reduced once,
    as a plain replicated 0-d tensor."""
    flat = tree_leaves(tree)
    if not isinstance(flat[0], DTensor):
        return torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                            for g in flat]).square().sum().sqrt()
    mesh = flat[0].device_mesh
    part = torch.stack([_sum_squares(g) for g in flat]).sum()
    total = DTensor.from_local(part, mesh, [Partial()] * mesh.ndim, run_check=False)
    return total.full_tensor().sqrt()


@torch.no_grad()
def cosine_schedule(step: torch.Tensor, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    s = step.float()
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0):
    """Returns (new_params, new_state, metrics), JAX's arithmetic: the clip
    scale min(1, clip / max(gnorm, 1e-9)), bias correction from the
    incremented step, the update built from the master copy (or the f32
    params), and decay on every leaf with ``ndim >= 2``, so the stacked
    per-block norm scales, (n_blocks, d), are decayed as JAX decays them.
    The params, moments and master copy are updated in place.

    Over DTensors each gradient takes its parameter's placements first (a
    ``Partial`` one is reduced), then every leaf updates its local shard;
    the metrics are plain replicated scalars."""
    with torch.profiler.record_function("adamw_update"):
        flat_p = tree_leaves(params)
        flat_g = [like_placements(g, p) for g, p in zip(tree_leaves(grads), flat_p)]
        gnorm = global_norm(flat_g)
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        b1c = 1 - b1 ** local_part(step).float()
        b2c = 1 - b2 ** local_part(step).float()
        lr = torch.as_tensor(local_part(lr), dtype=torch.float32, device=gnorm.device)
        flat_pm = (tree_leaves(state.master) if state.master is not None
                   else [None] * len(flat_p))
        for g, m, v, p, pm in zip(flat_g, tree_leaves(state.m), tree_leaves(state.v),
                                  flat_p, flat_pm):
            decay = weight_decay if p.dim() >= 2 else 0.0    # no decay on 1-d norms
            g, m, v, p, pm = map(local_part, (g, m, v, p, pm))
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            update = (m / b1c) / ((v / b2c).sqrt() + eps)
            base = pm if pm is not None else p.float()
            new_master = base - lr * (update + decay * base)
            if pm is not None:
                pm.copy_(new_master)
            p.copy_(new_master)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, AdamWState(step, state.m, state.v, state.master), metrics
