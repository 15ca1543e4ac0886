"""Step functions (train / prefill / decode) bound to a config, mirroring
``repro/launch/steps.py``.

PyTorch runs eagerly, so these are the functions the launch scripts call
(JAX jits them). With a ``mesh`` the params, optimizer state and batch are
DTensors placed by ``distributed.param_specs`` and ``data_spec``; the
gradients come back with their parameters' placements, and the metrics as
plain replicated scalars.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (P, constrain, like_placements, local_part,
                                              mesh_context)
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map, unflatten

LB_COEF = 0.01       # MoE load-balance aux weight (switch-transformer default)
Z_COEF = 1e-3        # router z-loss weight


def make_loss_fn(cfg: ModelConfig, mesh=None, remat: bool | str = True):
    def loss_fn(params, batch):
        hidden, aux = T.forward(params, batch["tokens"], cfg, positions=batch.get("positions"),
                                enc_frames=batch.get("enc_frames"),
                                vis_embeds=batch.get("vis_embeds"), remat=remat, mesh=mesh)
        ce = T.lm_loss(params, cfg, hidden, batch["labels"], batch.get("mask"), mesh=mesh)
        total = ce + LB_COEF * aux["lb"] + Z_COEF * aux["z"]
        return total, {"ce": ce, "lb": aux["lb"], "z": aux["z"]}
    return loss_fn


def make_grad_fn(cfg: ModelConfig, mesh=None, *, remat: bool | str = True,
                 microbatches: int = 1):
    """``grad_fn(params, batch) -> (grads, metrics)``: the train step's
    gradient, a tree like ``params``, and its metrics (``ce``, ``lb``, ``z``).

    With ``microbatches`` > 1 the batch's rows are cut into that many equal
    slices in order; their gradients are summed in f32 zero buffers and
    divided by the count, and the metrics averaged, as JAX's scan of
    gradient accumulation (the activation stash shrinks by the same factor).
    A leaf the loss does not reach gets a zero gradient, as under JAX.

    With a ``mesh`` a microbatch is the same rows of the global batch (a
    slice of a DTensor), each accumulator has its leaf's placements, and
    the metrics come back as plain replicated scalars."""
    loss_fn = make_loss_fn(cfg, mesh, remat)

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with mesh_context(mesh):
            total, metrics = loss_fn(unflatten(params, leaves), batch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else like_placements(g, p)
                 for g, p in zip(grads, leaves)]
        if mesh is not None:
            metrics = {k: local_part(constrain(v, mesh, P())) for k, v in metrics.items()}
        return unflatten(params, grads), {k: v.detach() for k, v in metrics.items()}

    def grad_fn(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"a batch of {rows} rows does not split into {microbatches} "
                             "microbatches")
        n = rows // microbatches
        g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        m_acc = None
        for i in range(microbatches):
            grads, metrics = grads_of(params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            for acc, g in zip(tree_leaves(g_acc), tree_leaves(grads)):
                acc.add_(g)
            del grads
            m_acc = metrics if m_acc is None else {k: m_acc[k] + metrics[k] for k in m_acc}
        for acc in tree_leaves(g_acc):
            acc.div_(microbatches)
        return g_acc, {k: v / microbatches for k, v in m_acc.items()}

    return grad_fn


def make_train_step(cfg: ModelConfig, mesh=None, *, remat: bool | str = True,
                    peak_lr: float = 3e-4, warmup: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``make_grad_fn``'s gradient, then AdamW at the cosine
    schedule's rate for ``opt_state.step`` (before its increment). The
    params and optimizer state are updated in place and returned."""
    grad_fn = make_grad_fn(cfg, mesh, remat=remat, microbatches=microbatches)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_fn(params, batch)
        lr = cosine_schedule(local_part(opt_state.step), peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, lr=lr,
                                                      weight_decay=weight_decay)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: int, mesh=None):
    def prefill_step(params, batch):
        return T.prefill(params, batch["tokens"], cfg, max_seq,
                         positions=batch.get("positions"),
                         enc_frames=batch.get("enc_frames"),
                         vis_embeds=batch.get("vis_embeds"), mesh=mesh)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, *, sample: bool = False):
    def decode_step(params, cache, batch):
        logits, cache = T.decode_step(params, batch["tokens"], cache, cfg,
                                      positions=batch.get("positions"), mesh=mesh)
        if sample:
            tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
            return tok[:, None], cache
        return logits, cache
    return decode_step
