"""Neural-net building blocks in PyTorch: norms, RoPE/M-RoPE, attention (GQA /
sliding window / softcap / qk-norm), MLPs. Plain functions over dicts of
tensors, mirroring ``repro/models/layers.py`` name for name.

Conventions:
  * activations (B, S, D); attention heads materialized as (B, S, H, hd);
  * params are dicts of tensors; init fns take a ``torch.Generator`` and a
    device and return them;
  * math in the config dtype (bf16 on the card), softmax/logits in f32. Where
    JAX contracts bf16 operands with f32 accumulation and f32 output
    (``preferred_element_type``), the port casts the operands to f32 first:
    the products of bf16 values are exact in f32, so only the order of the
    sums differs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def init_rmsnorm(d: int, device=None) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# Positions: RoPE and M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, hd). positions: (B, S) or (B, 3, S) for M-RoPE.

    Half-split rotation: the first and second halves of hd form the pairs.
    M-RoPE (qwen2-vl): the hd/2 rotary frequencies are split into sections
    (t, h, w); each section rotates by its own position stream.
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                        # (hd/2,)
    if mrope_sections:
        assert positions.dim() == 3, "M-RoPE needs (B, 3, S) positions"
        sec_id = torch.repeat_interleave(
            torch.arange(len(mrope_sections), device=x.device),
            torch.tensor(mrope_sections, device=x.device))       # (hd/2,)
        pos = positions.float()[:, sec_id, :]                    # (B, hd/2, S)
        angles = pos.transpose(1, 2) * inv[None, None, :]        # (B, S, hd/2)
    else:
        angles = positions.float()[..., None] * inv              # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_normal(shape, generator, device, scale: float, dtype) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 on ``device``, stored in ``dtype``."""
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def init_attention(generator, cfg: ModelConfig, device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = d ** -0.5
    dt = getattr(torch, cfg.dtype)
    p = {
        "wq": init_normal((d, h * hd), generator, device, scale, dt),
        "wk": init_normal((d, kv * hd), generator, device, scale, dt),
        "wv": init_normal((d, kv * hd), generator, device, scale, dt),
        "wo": init_normal((h * hd, d), generator, device, scale, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
    return p


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def _dense_attention(q, k, v, *, causal: bool, window: int, softcap: float,
                     q_offset: int = 0) -> torch.Tensor:
    """Materialized attention. q: (B,Sq,H,hd) k/v: (B,Sk,KV,hd).

    As in JAX: q * hd**-0.5 is rounded back to q's dtype, the logits and the
    output are contracted with f32 accumulation, the weights are rounded to
    v's dtype."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qf = (q.float() * (hd ** -0.5)).to(q.dtype)
    qf = qf.reshape(b, sq, kvh, rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qf.float(), k.float())
    logits = _softcap(logits, softcap)
    if causal or window:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _chunked_attention(q, k, v, *, causal: bool, window: int, softcap: float,
                       kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style online-softmax attention, looping over KV chunks in f32.

    Memory O(Sq * kv_chunk) instead of O(Sq * Skv); used for long prefill.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    n_chunks = -(-skv // kv_chunk)
    qf = (q.float() * (hd ** -0.5)).reshape(b, sq, kvh, rep, hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, kvh, rep, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, rep, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, rep, sq, hd), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        vb = v[:, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        pad = kv_chunk - kb.shape[1]
        if pad:
            kb = F.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = F.pad(vb, (0, 0, 0, 0, 0, pad))
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qf, kb)
        logits = _softcap(logits, softcap)
        kpos = ci * kv_chunk + torch.arange(kv_chunk, device=q.device)[None, :]
        mask = kpos < skv
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & (kpos > qpos - window)
        logits = logits.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def multihead_attention(x, params, cfg: ModelConfig, *, positions,
                        window: int = 0, causal: bool = True,
                        q_offset: int = 0,
                        dense_threshold: int | None = None) -> torch.Tensor:
    """Full self-attention over x (B, S, D)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kvh, hd)
    v = (x @ params["wv"]).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    if dense_threshold is None:
        dense_threshold = cfg.attn_dense_threshold
    if s > dense_threshold:
        out = _chunked_attention(q, k, v, causal=causal, window=window,
                                 softcap=cfg.attn_softcap)
    else:
        out = _dense_attention(q, k, v, causal=causal, window=window,
                               softcap=cfg.attn_softcap, q_offset=q_offset)
    return out.reshape(b, s, h * hd) @ params["wo"]


def project_kv(x, params, cfg: ModelConfig, positions):
    """K/V projections only (the prefill cache write)."""
    b, s, _ = x.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k = (x @ params["wk"]).reshape(b, s, kvh, hd)
    v = (x @ params["wv"]).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.rope_theta and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return k, v


# ---------------------------------------------------------------------------
# Decode-time attention over gathered dense KV (the paged pool path is
# serving/paged_model.py)
# ---------------------------------------------------------------------------

def decode_attention(q, k_ctx, v_ctx, *, lengths, softcap: float = 0.0,
                     kpos=None) -> torch.Tensor:
    """q: (B,1,H,hd); k_ctx/v_ctx: (B,S,KV,hd); lengths: (B,) valid KV count.

    kpos optionally gives absolute key positions (B,S) for windowed caches
    where the window is a rotating buffer. As in JAX, q * hd**-0.5 is
    rounded to the cache's dtype and the weights to v's dtype, with f32
    accumulation."""
    b, _, h, hd = q.shape
    skv, kvh = k_ctx.shape[1], k_ctx.shape[2]
    rep = h // kvh
    qf = (q.float() * (hd ** -0.5)).reshape(b, kvh, rep, hd)
    logits = torch.einsum("bgrd,bkgd->bgrk", qf.to(k_ctx.dtype).float(), k_ctx.float())
    logits = _softcap(logits, softcap)
    if kpos is None:
        valid = torch.arange(skv, device=q.device)[None, :] < lengths[:, None]
    else:
        valid = kpos < lengths[:, None]
    logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", w.to(v_ctx.dtype).float(), v_ctx.float())
    return out.reshape(b, 1, h * hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg: ModelConfig, d_ff: int | None = None, device=None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    return {
        "w_gate": init_normal((d, f), generator, device, d ** -0.5, dt),
        "w_up": init_normal((d, f), generator, device, d ** -0.5, dt),
        "w_down": init_normal((f, d), generator, device, f ** -0.5, dt),
    }


def mlp(x, params, act: str = "silu") -> torch.Tensor:
    a = F.silu if act == "silu" else (lambda t: F.gelu(t, approximate="tanh"))
    return (a(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
