"""AdamW with global-norm clipping, a cosine schedule and an optional f32
master copy, mirroring ``repro/optim/adamw.py``.

Plain functions on the parameter tree (dicts and tuples of tensors, the
JAX tree's layout), under ``torch.no_grad``. Where JAX returns new arrays,
``adamw_update`` writes the new moments, master copy and parameters into
the tensors it was given and returns them in the same tree: at full size a
second copy of the state would not fit beside the first.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor               # 0-d int32
    m: Any
    v: Any
    master: Optional[Any] = None     # f32 weights when params are bf16


@torch.no_grad()
def adamw_init(params: Any, master_fp32: bool = True) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    master = None
    if master_fp32 and any(p.dtype != torch.float32 for p in tree_leaves(params)):
        master = tree_map(lambda p: p.float().clone(), params)
    first = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params), master=master)


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                        for g in tree_leaves(tree)]).square().sum().sqrt()


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
    The params, moments and master copy are updated in place."""
    with torch.profiler.record_function("adamw_update"):
        gnorm = global_norm(grads)
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        b1c = 1 - b1 ** step.float()
        b2c = 1 - b2 ** step.float()
        lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
        flat_p = tree_leaves(params)
        flat_pm = (tree_leaves(state.master) if state.master is not None
                   else [None] * len(flat_p))
        for g, m, v, p, pm in zip(tree_leaves(grads), tree_leaves(state.m),
                                  tree_leaves(state.v), flat_p, flat_pm):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            update = (m / b1c) / ((v / b2c).sqrt() + eps)
            base = pm if pm is not None else p.float()
            decay = weight_decay if p.dim() >= 2 else 0.0    # no decay on 1-d norms
            new_master = base - lr * (update + decay * base)
            if pm is not None:
                pm.copy_(new_master)
            p.copy_(new_master)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, AdamWState(step, state.m, state.v, state.master), metrics
