"""Mixture-of-Experts FFN in PyTorch, mirroring ``repro/models/moe.py``:
top-k routing and a capacity-bounded, sort-free dispatch.

Dispatch is gather/scatter based: each expert gets a buffer of ``cap`` token
rows (``_capacity``), the three per-expert products run as batched matmuls
over ``(E, cap, d)``, and the combine gathers each kept assignment's row back.
Every expert's buffer is computed whatever its fill, as in JAX, so a decode
step reads every expert's weights.

Only the local path is ported: ``moe_ffn`` with a mesh (the JAX
``shard_map`` expert- and tensor-parallel paths) raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import init_normal


def init_moe(generator, cfg: ModelConfig, device=None) -> dict:
    """The router in float32, the experts in the config dtype, with JAX's
    layout and scales (N(0,1) * d**-0.5 in, * d_ff**-0.5 out)."""
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    dt = getattr(torch, cfg.dtype)
    s_in, s_out = d ** -0.5, f ** -0.5
    return {
        "router": init_normal((d, e), generator, device, s_in, torch.float32),
        "w_gate": init_normal((e, d, f), generator, device, s_in, dt),
        "w_up": init_normal((e, d, f), generator, device, s_in, dt),
        "w_down": init_normal((e, f, d), generator, device, s_out, dt),
    }


def _capacity(tokens: int, cfg: ModelConfig, factor: float | None = None) -> int:
    """Rows of each expert's buffer: T*k/E * factor, rounded up to 8, at least 8."""
    f = cfg.moe_capacity_factor if factor is None else factor
    c = int(tokens * cfg.moe_topk / cfg.moe_experts * f)
    return max(8, -(-c // 8) * 8)


def route(x, params, cfg: ModelConfig):
    """Router of ``moe_local``. x: (T, d). Returns the renormalised top-k
    weights (T, k) f32, the expert ids (T, k) and the aux losses."""
    e, k_top = cfg.moe_experts, cfg.moe_topk
    logits = x.float() @ params["router"]                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k_top, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)                                            # (E,)
    ce = F.one_hot(idx, e).float().sum(1).mean(dim=0) / k_top
    aux = {"lb": e * torch.sum(me * ce),
           "z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return w, idx, aux


def dispatch(idx, n_experts: int, cap: int):
    """Sort-free capacity dispatch of the (T, k) expert ids: an assignment's
    slot is the running count of its expert over the T*k assignments in
    token-major order. Returns (keep (T*k,) bool: slot < cap, dest (T*k,):
    expert * cap + slot where kept, else the overflow slot E * cap)."""
    e_flat = idx.reshape(-1)
    pos = (torch.cumsum(F.one_hot(e_flat, n_experts), dim=0) - 1).gather(1, e_flat[:, None])[:, 0]
    keep = pos < cap
    return keep, torch.where(keep, e_flat * cap + pos, n_experts * cap)


def moe_local(x, params, cfg: ModelConfig, *, capacity_factor: float | None = None):
    """x: (B, S, d). Returns (y (B, S, d), {"lb", "z"})."""
    b, s, d = x.shape
    e, k_top = cfg.moe_experts, cfg.moe_topk
    t = b * s
    xf = x.reshape(t, d)
    w, idx, aux = route(xf, params, cfg)

    cap = _capacity(t, cfg, capacity_factor)
    keep, dest = dispatch(idx, e, cap)
    token = torch.arange(t * k_top, device=x.device) // k_top
    buf = torch.full((e * cap + 1,), t, dtype=torch.long, device=x.device)
    # kept slots are unique; the overflow slot is cut off unread
    buf = buf.scatter(0, dest, token)[:e * cap]

    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xg = x_pad[buf].reshape(e, cap, d)                                # (E, C, d)
    act = F.silu if cfg.act == "silu" else (lambda v: F.gelu(v, approximate="tanh"))
    h = act(torch.bmm(xg, params["w_gate"])) * torch.bmm(xg, params["w_up"])
    y = torch.bmm(h, params["w_down"]).reshape(e * cap, d)

    out_tk = y[torch.where(keep, dest, 0)]                           # (T*K, d)
    out_tk = torch.where(keep[:, None], out_tk, out_tk.new_zeros(()))
    out = (out_tk.reshape(t, k_top, d) * w[..., None].to(y.dtype)).sum(dim=1)
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_ffn(x, params, cfg: ModelConfig, mesh=None):
    """MoE FFN. x: (B, S, d). The JAX ``shard_map`` paths over a mesh are
    not ported: a mesh raises."""
    if mesh is not None:
        raise NotImplementedError("moe_ffn over a mesh (expert/tensor parallel) is not "
                                  "ported yet: it comes with the distribution slice")
    return moe_local(x, params, cfg)
