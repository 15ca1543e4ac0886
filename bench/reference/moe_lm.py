"""Plain PyTorch reference of the attention + MoE language model the
benchmark's configurations describe, in float32 with TF32 off.

It follows the program's equations, not the published models' where the
two part (each configuration file lists the departures): pre-norm blocks
with RMSNorm as ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``, per-head
q/k RMSNorm, half-split RoPE, causal GQA attention, a top-k router whose
weights are renormalised over the k chosen, and the capacity-bounded
dispatch: an expert keeps at most ``cap`` of a call's assignments, counted
in token-major order, ``cap = max(8, ceil8(int(T * k / E * factor)))``.

It imports nothing of the program. It reads a configuration file's
``port`` sizes and the weights the benchmark drew (the program's tree
layout), upcasting them a layer at a time.

``Matmul`` is the one place products are formed; ``Matmul("fp8")``
rounds both operands of every projection, expert and head product to
float8 e4m3 (a scale per tensor) before the float32 product: the control
that stands in for a program computed a precision below bfloat16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
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


def capacity(tokens: int, topk: int, experts: int, factor: float) -> int:
    c = int(tokens * topk / experts * factor)
    return max(8, -(-c // 8) * 8)


def moe(x, p, sz: dict, mm: Matmul, prefix: int | None = None):
    """x (T, d) in token-major order. Returns (y (T, d), lb, z). The
    capacity rule holds over the first ``prefix`` tokens (a prefill call of
    that many); the tokens after them are decode steps, each routed in its
    own call, and keep every assignment. ``prefix`` None: one call of all T."""
    t = x.shape[0]
    e, k = sz["moe_experts"], sz["moe_topk"]
    logits = x @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    n = t if prefix is None else prefix
    cap = capacity(n, k, e, sz["moe_capacity_factor"])
    flat = idx.reshape(-1)
    first = flat[: n * k]
    # each assignment's slot: the assignments to its expert before it (a scan
    # along each expert's row, which runs fast where one down the columns
    # of a (T*k, E) table does not)
    counts = torch.cumsum(F.one_hot(first, e).T.contiguous(), dim=1).T
    slot = (counts - 1).gather(1, first[:, None])[:, 0]
    keep = torch.cat([slot < cap, torch.ones(flat.numel() - n * k, dtype=torch.bool,
                                             device=x.device)])
    wk = (w.reshape(-1) * keep).reshape(t, k)
    y = torch.zeros_like(x)
    act = F.silu if sz.get("act", "silu") == "silu" else (lambda a: F.gelu(a, approximate="tanh"))
    for j in range(e):
        tok, kk = torch.nonzero((idx == j) & keep.reshape(t, k), as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        hcur = act(mm(xe, p["w_gate"][j])) * mm(xe, p["w_up"][j])
        y = y.index_add(0, tok, mm(hcur, p["w_down"][j]) * wk[tok, kk][:, None])
    me = probs.mean(0)
    ce = F.one_hot(idx, e).float().sum(1).mean(0) / k
    lb = e * (me * ce).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return y, lb, z


def layer(x, p, sz: dict, mm: Matmul, pos, prefix=None):
    """One block on x (B, S, d). Returns (x, lb, z)."""
    b, s, d = x.shape
    h_, kv, hd = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    eps = sz["norm_eps"]
    hn = rmsnorm(x, p["norm"], eps)
    a = p["attn"]
    q = mm(hn, a["wq"]).reshape(b, s, h_, hd)
    k = mm(hn, a["wk"]).reshape(b, s, kv, hd)
    v = mm(hn, a["wv"]).reshape(b, s, kv, hd)
    if "q_norm" in a:
        q, k = rmsnorm(q, a["q_norm"], eps), rmsnorm(k, a["k_norm"], eps)
    theta = sz["rope_theta"]
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    x = x + mm(causal_attention(q, k, v).reshape(b, s, h_ * hd), a["wo"])
    hn = rmsnorm(x, p["ffn_norm"], eps).reshape(b * s, d)
    y, lb, z = moe(hn, p["moe"], sz, mm, prefix)
    return x + y.reshape(b, s, d), lb, z


def layer_weights(params: dict, l: int) -> dict:
    """Block ``l`` of the stacked tree, in float32."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[l].float()
    return pick(params["blocks"][0])


def head(params: dict, sz: dict) -> torch.Tensor:
    return params["embed"].float().T if sz["tie_embeddings"] else params["lm_head"].float()


@torch.no_grad()
def served_logits(params: dict, sz: dict, seqs: list[tuple[list[int], int]],
                  precision: str = "fp32") -> list[torch.Tensor]:
    """For each (tokens, prompt_len) of ``seqs``, tokens = prompt + served
    tokens but the last: the logits (n, V) at the positions that chose the
    n served tokens (the prompt's last position on). The prompt is one
    prefill call (its capacity), each later token a step of its own. Layer
    by layer over the sequences, so each layer's weights are upcast once."""
    mm = Matmul(precision)
    dev = params["embed"].device
    xs = [params["embed"][torch.tensor(t, device=dev)].float()[None] for t, _ in seqs]
    pos = [torch.arange(len(t), device=dev) for t, _ in seqs]
    for l in range(sz["n_layers"]):
        w = layer_weights(params, l)
        xs = [layer(x, w, sz, mm, p, prefix=n)[0] for x, p, (_, n) in zip(xs, pos, seqs)]
        del w
    w_out = head(params, sz)
    fn = params["final_norm"].float()
    return [mm(rmsnorm(x[0, n - 1:], fn, sz["norm_eps"]), w_out) for x, (_, n) in zip(xs, seqs)]
