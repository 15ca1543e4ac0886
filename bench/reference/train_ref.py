"""Plain PyTorch reference of the training cell's first steps: the loss,
its gradient and AdamW, in float32 with TF32 off, over the same weights
and batches the program got.

The loss follows the program's equations (the layers of the configuration's
family, ``reference/<family>.py``, each called with its index; a mean
cross-entropy over every position plus the load-balance and router z terms
summed over the layers); each microbatch's gradient is averaged, clipped to
a global norm of 1.0, and AdamW (b1 0.9, b2 0.95, eps 1e-8, decay on every
leaf of two or more dims) steps at the cell's cosine schedule, from a
float32 master copy. Each layer, each attention chunk and each loss chunk
runs under a checkpoint, so the activations of one layer at a time are
held.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import family
from .plain import Matmul, no_tf32, rmsnorm

B1, B2, EPS, CLIP = 0.9, 0.95, 1e-8, 1.0


def flat(tree, prefix: str = "") -> dict:
    """{"path": tensor} of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def lr_at(step: int, opt: dict) -> float:
    """The cosine schedule with linear warm-up (floor 0.1 of the peak)."""
    peak, warm, total = opt["peak_lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def loss(w: dict, fam, sz: dict, tokens, labels, mm, lb_coef: float, z_coef: float):
    """The program's training loss on float32 leaves ``w`` (paths of the
    program's tree), with the layers of the family module ``fam``."""
    b, s = tokens.shape
    x = w["embed"][tokens]
    pos = torch.arange(s, device=tokens.device)
    lb = z = torch.zeros((), device=tokens.device)
    for l in range(sz["n_layers"]):
        p = fam.layer_leaves(w, l, sz)
        x, lb_l, z_l = checkpoint(fam.layer, x, p, l, sz, mm, pos, use_reentrant=False)
        lb, z = lb + lb_l, z + z_l
    x = rmsnorm(x, w["final_norm"], sz["norm_eps"])
    head = w["embed"].T if sz["tie_embeddings"] else w["lm_head"]

    def chunk(xc, lc):
        lg = mm(xc, head)
        return (torch.logsumexp(lg, -1) - lg.gather(-1, lc[..., None])[..., 0]).sum()

    c = min(1024, s)
    ce = sum(checkpoint(chunk, x[:, i:i + c], labels[:, i:i + c], use_reentrant=False)
             for i in range(0, s, c)) / (b * s)
    return ce + lb_coef * lb + z_coef * z


def run_steps(params: dict, conf: dict, batches: list, opt: dict, microbatches: int,
              precision: str = "fp32") -> dict:
    """``len(batches)`` steps from the weights ``params`` (the program's
    tree, any dtype; read in float32) of the configuration ``conf``.
    Returns each step's loss, the norm of each leaf's clipped first
    gradient, and the norm of each leaf's change over all the steps."""
    no_tf32()
    fam, sz = family(conf), conf["port"]
    mm = Matmul(precision)
    master = {k: v.detach().float().clone() for k, v in flat(params).items()}
    start = {k: v.clone() for k, v in master.items()}
    m = {k: torch.zeros_like(v) for k, v in master.items()}
    v2 = {k: torch.zeros_like(v) for k, v in master.items()}
    losses, first_grad = [], None
    for step, bt in enumerate(batches):
        grads = {k: torch.zeros_like(t) for k, t in master.items()}
        total = 0.0
        rows = bt["tokens"].shape[0] // microbatches
        for i in range(microbatches):
            sl = slice(i * rows, (i + 1) * rows)
            w = {k: t.clone().requires_grad_() for k, t in master.items()}
            out = loss(w, fam, sz, bt["tokens"][sl], bt["labels"][sl], mm, opt["lb_coef"],
                       opt["z_coef"])
            gs = torch.autograd.grad(out, list(w.values()), allow_unused=True)
            for k, g in zip(w, gs):
                if g is not None:
                    grads[k] += g / microbatches
            total += out.item() / microbatches
            del w, out, gs
        losses.append(total)
        gnorm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
        scale = min(1.0, CLIP / max(gnorm, 1e-9))
        t = step + 1
        lr = lr_at(step, opt)
        for k in master:
            g = grads[k] * scale
            m[k].mul_(B1).add_((1 - B1) * g)
            v2[k].mul_(B2).add_((1 - B2) * g.square())
            upd = (m[k] / (1 - B1 ** t)) / ((v2[k] / (1 - B2 ** t)).sqrt() + EPS)
            decay = opt["weight_decay"] if master[k].dim() >= 2 else 0.0
            master[k] -= lr * (upd + decay * master[k])
        if step == 0:
            first_grad = {k: float((grads[k] * scale).norm()) for k in master}
        del grads
    change = {k: float((master[k] - start[k]).norm()) for k in master}
    return {"losses": losses, "first_grad": first_grad, "change": change}
