"""The plain pieces every family's reference shares, in float32 with TF32 off:
RMSNorm as ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, half-split RoPE,
causal GQA attention, and the one place products are formed.

``Matmul("fp8")`` rounds both operands of every projection, expert and
head product to float8 e4m3 (a scale per tensor) before the float32
product: the control that stands in for a program computed a precision
below bfloat16.

It imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale for the tensor, back in f32."""
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Matmul:
    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = fp8_round(a), fp8_round(b)
        return a @ b


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, pos, theta):
    """x (..., S, H, hd), pos (S,): the first and second halves of hd pair up."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos.float()[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend_rows(q, k, v, q0: int):
    """Causal attention of the queries at q0.. (B, c, H, hd) over keys
    0..q0+c-1, GQA by repeating K/V heads."""
    b, c, h, hd = q.shape
    rep = h // k.shape[2]
    n = q0 + c
    kk = k[:, :n].repeat_interleave(rep, dim=2)
    vv = v[:, :n].repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
    qi = torch.arange(q0, n, device=q.device)[:, None]
    ki = torch.arange(n, device=q.device)[None, :]
    s = s.masked_fill(ki > qi, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv)


def causal_attention(q, k, v, chunk: int = 512):
    """q (B, S, H, hd), k/v (B, S, KV, hd), query chunks under a checkpoint
    when a gradient is recorded, so no (S, S) score of the whole sequence
    is held."""
    outs = []
    for q0 in range(0, q.shape[1], chunk):
        qc = q[:, q0:q0 + chunk]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_rows, qc, k, v, q0, use_reentrant=False))
        else:
            outs.append(_attend_rows(qc, k, v, q0))
    return torch.cat(outs, dim=1)
