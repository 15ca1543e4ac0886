"""Neural-net building blocks in PyTorch: norms, RoPE/M-RoPE, sinusoidal
positions, attention (GQA / sliding window / softcap / qk-norm /
cross-attention), MLPs. Plain functions over dicts of
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

import contextlib
from functools import partial

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import pmax, psum
from repro_torch.distributed.sharding import (P, contiguous_grad, cut_axes, dp_axes, dp_size,
                                              grad_in_placements, placements, replicate)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import mesh_shape

NEG_INF = -1e30


def profiling() -> bool:
    """Whether a profiler records: torch's process-wide flag, which every
    profiler sets (one that follows all threads too), else this thread's."""
    return (getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
            or torch.autograd._profiler_enabled())


def profiled(name: str):
    """``record_function(name)`` while a profiler records, else a context
    that does nothing: a range on the trace's timeline, and no op outside a
    profiler."""
    return torch.profiler.record_function(name) if profiling() else contextlib.nullcontext()


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
        # stream i repeated over its section's width: views and one copy,
        # no tensor built from host values (a CUDA graph replays the step)
        pos = torch.cat([positions[:, i:i + 1].expand(-1, n, -1)
                         for i, n in enumerate(mrope_sections)], dim=1).float()  # (B, hd/2, S)
        angles = pos.transpose(1, 2) * inv[None, None, :]        # (B, S, hd/2)
    else:
        angles = positions.float()[..., None] * inv              # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings in f32; positions (B, S) -> (B, S, D)."""
    half = d_model // 2
    log_base = torch.log(torch.tensor(10000.0, device=positions.device))
    freqs = torch.exp(-log_base * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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


def _attend(q, k, v, *, causal: bool, window: int, softcap: float, q_offset: int,
            dense_threshold: int) -> torch.Tensor:
    """The attention core on plain tensors: the Hopper flash kernel on the
    card, the dense or chunked plain version on the CPU."""
    if q.is_cuda:
        return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, window=window, softcap=softcap,
                                   q_offset=q_offset)
    if max(q.shape[1], k.shape[1]) > dense_threshold:
        return _chunked_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    return _dense_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                            q_offset=q_offset)


def scale_queries(q, cfg: ModelConfig):
    """q times ``cfg.attention_multiplier * head_dim**0.5`` where the config
    has one, so that attention, which scales its scores by head_dim**-0.5
    (the flash kernel's fixed scale), scales them by the multiplier."""
    if cfg.attention_multiplier is None:
        return q
    return q * (cfg.attention_multiplier * cfg.head_dim ** 0.5)


def head_split(mesh, n_heads: int, kv_heads: int) -> str | None:
    """How attention's heads go over ``model``: ``"kv"`` where it divides
    the KV heads (each rank whole GQA groups, query and KV heads cut
    together); ``"q"`` where it divides the query heads and is a multiple
    of the KV heads (tinyllama's 32 and 4 on 16 ranks: a rank's 2 query
    heads share one KV head, which it alone uses); else None, every head on
    every rank."""
    tp = mesh_shape(mesh)["model"]
    if kv_heads % tp == 0:
        return "kv"
    if n_heads % tp == 0 and tp % kv_heads == 0:
        return "q"
    return None


def head_placements(mesh, batch: int | None, n_heads: int, kv_heads: int) -> tuple:
    """(query, KV, KV gradient) placements of (B, S, heads, hd) tensors on
    ``mesh`` for attention under ``local_map``: the batch over the
    data-parallel axes where they divide it (``batch`` None: replicated);
    the heads as ``head_split`` cuts them. Under ``"q"`` the K/V come
    replicated over ``model`` and each rank reads its KV head
    (``kv_for_rank``), so their gradient is a sum over ``model``
    (``Partial``)."""
    dp = dp_axes(mesh) if batch is not None and batch % dp_size(mesh) == 0 else None
    split = head_split(mesh, n_heads, kv_heads)
    q = placements(P(dp, None, "model" if split else None, None), mesh)
    kv = placements(P(dp, None, "model" if split == "kv" else None, None), mesh)
    if split != "q":
        return q, kv, kv
    names = list(mesh_shape(mesh))
    grad = [Partial() if i == names.index("model") else p for i, p in enumerate(kv)]
    return q, kv, grad


def kv_for_rank(x: torch.Tensor, mesh, n_heads: int, kv_heads: int) -> torch.Tensor:
    """This rank's KV heads of a local (..., KV, hd) tensor that holds every
    KV head: under ``head_split`` ``"q"`` the one its query heads read
    (query head j reads KV head j // (H / KV)), else all of them."""
    if mesh is None or head_split(mesh, n_heads, kv_heads) != "q":
        return x
    i = mesh.get_local_rank("model") * kv_heads // mesh_shape(mesh)["model"]
    return x[..., i:i + 1, :]


def local_kv_heads(n_heads: int, kv_heads: int, mesh) -> int:
    """KV heads a rank's page pool holds: its share over ``model`` under
    ``head_split`` ``"kv"``, its one KV head under ``"q"``, else all."""
    if mesh is None:
        return kv_heads
    split = head_split(mesh, n_heads, kv_heads)
    return kv_heads // mesh_shape(mesh)["model"] if split == "kv" else 1 if split else kv_heads


def split_heads(x, heads: int, hd: int):
    """(..., heads * hd) -> (..., heads, hd). A DTensor whose last dim is
    cut over a mesh dim that does not divide ``heads`` (tinyllama's 4 KV
    heads on a 16-wide ``model`` axis) is first gathered on that mesh dim:
    DTensor cannot cut one mesh dim over two tensor dims, where GSPMD tiles
    heads and head_dim. The heads then stay replicated over it, as
    ``head_placements`` has them."""
    if isinstance(x, DTensor):
        pl = [Replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1 and heads % n else p
              for p, n in zip(x.placements, x.device_mesh.shape)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], heads, hd)


def multihead_attention(x, params, cfg: ModelConfig, *, positions,
                        window: int = 0, causal: bool = True,
                        kv_override=None, q_offset: int = 0,
                        dense_threshold: int | None = None, mesh=None) -> torch.Tensor:
    """Full self-attention over x (B, S, D), or cross-attention with
    ``kv_override=(k, v)``: Q is projected from x, K/V (B, Skv, KV, hd) come
    from the override and get no k-norm and no rope.

    On the card, attention at every length is the Hopper flash kernel
    (``ops.flash_attention``, Sq and Skv as they come), the counterpart of
    both ``_dense_attention`` and ``_chunked_attention`` (f32 math
    throughout, as the Pallas kernel). On the CPU the JAX rule holds: dense
    while ``max(Sq, Skv)`` is at most ``dense_threshold``, chunked past it.

    With a ``mesh`` and DTensor activations the core runs under
    ``local_map`` on each card's batch rows and heads (``head_placements``;
    under ``head_split`` ``"q"`` its query heads and their one KV head):
    the kernel sees plain local tensors, and its gradient flows back through
    ``local_map``."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(x @ params["wq"], h, hd)
    if kv_override is None:
        k = split_heads(x @ params["wk"], kvh, hd)
        v = split_heads(x @ params["wv"], kvh, hd)
    else:
        k, v = kv_override
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        if kv_override is None:
            k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.rope_theta and kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    q = scale_queries(q, cfg)
    attend = partial(_attend, causal=causal, window=window, softcap=cfg.attn_softcap,
                     q_offset=q_offset, dense_threshold=(cfg.attn_dense_threshold
                                                         if dense_threshold is None
                                                         else dense_threshold))
    if mesh is not None and isinstance(q, DTensor):
        q_pl, kv_pl, kv_grad = head_placements(mesh, b, h, k.shape[2])
        k, v = replicate(k, mesh), replicate(v, mesh)
        core, pick = attend, partial(kv_for_rank, mesh=mesh, n_heads=h, kv_heads=k.shape[2])
        attend = local_map(
            lambda q, k, v: core(*map(contiguous_grad, (q, pick(k), pick(v)))),
            out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
            in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh,
            redistribute_inputs=True)
    out = attend(q, k, v)
    return grad_in_placements(out.reshape(b, s, h * hd)) @ params["wo"]


def project_kv(x, params, cfg: ModelConfig, positions):
    """K/V projections only (the prefill cache write, the cross-attention
    memory)."""
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k = split_heads(x @ params["wk"], kvh, hd)
    v = split_heads(x @ params["wv"], kvh, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.rope_theta and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return k, v


# ---------------------------------------------------------------------------
# Decode-time attention over gathered dense KV (the paged pool path is
# serving/paged_model.py)
# ---------------------------------------------------------------------------

def _decode_logits(q, k_ctx, *, lengths, softcap: float, kpos):
    """(B, KV, rep, S) f32 logits of a decode query over ``k_ctx``, keys
    at or past ``lengths`` (by ``kpos`` where given) at ``NEG_INF``."""
    b, _, h, hd = q.shape
    skv, kvh = k_ctx.shape[1], k_ctx.shape[2]
    qf = (q.float() * (hd ** -0.5)).reshape(b, kvh, h // kvh, hd)
    logits = torch.einsum("bgrd,bkgd->bgrk", qf.to(k_ctx.dtype).float(), k_ctx.float())
    logits = _softcap(logits, softcap)
    if kpos is None:
        valid = torch.arange(skv, device=q.device)[None, :] < lengths[:, None]
    else:
        valid = kpos < lengths[:, None]
    return logits.masked_fill(~valid[:, None, None], NEG_INF)


def decode_attention(q, k_ctx, v_ctx, *, lengths, softcap: float = 0.0,
                     kpos=None) -> torch.Tensor:
    """q: (B,1,H,hd); k_ctx/v_ctx: (B,S,KV,hd); lengths: (B,) valid KV count.

    kpos optionally gives absolute key positions (B,S) for windowed caches
    where the window is a rotating buffer. As in JAX, q * hd**-0.5 is
    rounded to the cache's dtype and the weights to v's dtype, with f32
    accumulation."""
    b, _, h, hd = q.shape
    w = torch.softmax(_decode_logits(q, k_ctx, lengths=lengths, softcap=softcap, kpos=kpos),
                      dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", w.to(v_ctx.dtype).float(), v_ctx.float())
    return out.reshape(b, 1, h * hd).to(q.dtype)


def decode_attention_partial(q, k_ctx, v_ctx, *, lengths, softcap: float = 0.0, kpos=None):
    """``decode_attention`` over one slice of the keys, before the softmax's
    normalization: (o (B, H, hd), m (B, H), l (B, H)) in f32, with m the
    slice's largest logit, l the sum of exp(logit - m) and o those weights'
    sum of values. A slice with no valid key has m = NEG_INF, and the
    combine gives it weight 0. ``combine_partials`` over the ranks that
    hold the other slices gives the softmax over every key: the combine
    GSPMD inserts for JAX's decode over a sequence-cut cache."""
    b, _, h, hd = q.shape
    logits = _decode_logits(q, k_ctx, lengths=lengths, softcap=softcap, kpos=kpos)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    o = torch.einsum("bgrk,bkgd->bgrd", p.to(v_ctx.dtype).float(), v_ctx.float())
    return o.reshape(b, h, hd), m.reshape(b, h), p.sum(dim=-1).reshape(b, h)


def combine_partials(o, m, l, groups) -> torch.Tensor:
    """The attention output (B, H, hd) f32 over the key slices held by the
    ranks of ``groups`` (one process group per mesh axis the keys are cut
    over), the same on each of them: the largest logit by ``pmax`` of
    ``m``, then each slice's ``o`` and ``l`` rescaled to it and summed."""
    scale = torch.exp(m - pmax(m, groups))
    ol = psum(torch.cat([o * scale[..., None], (l * scale)[..., None]], dim=-1), groups)
    return ol[..., :-1] / ol[..., -1:]


def decode_cross_attention(x, params, cfg: ModelConfig, kv, mesh=None) -> torch.Tensor:
    """Decode-time cross-attention (whisper): x (B, 1, D) attends over the
    whole precomputed encoder K/V ({"k", "v"}: (B, enc_seq, KV, hd)), every
    key valid. Through ``decode_attention``, as in JAX, which has no kernel
    on this path (a flash launch at Sq 1 would leave all but one row of its
    query tile idle). With a ``mesh`` and DTensor K/V (the cache's, placed
    by ``cache_specs``: rows over the data axes, the encoder sequence over
    ``model`` where it divides) it runs under ``local_map``: each rank
    attends over its rows' slice of the keys with every head, and the
    slices meet in ``combine_partials``."""
    h, hd = cfg.n_heads, cfg.head_dim
    q = scale_queries(split_heads(x @ params["wq"], h, hd), cfg)

    def attend(q, k, v, groups=()):
        lengths = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=q.device)
        if not groups:
            return decode_attention(q, k, v, lengths=lengths)
        o, m, l = decode_attention_partial(q, k, v, lengths=lengths)
        return combine_partials(o, m, l, groups).reshape(q.shape[0], 1, -1).to(q.dtype)

    if mesh is not None and isinstance(kv["k"], DTensor):
        rows = cut_axes(kv["k"], 0)
        pl = placements(P(rows, None, None), mesh)
        groups = [mesh.get_group(a) for a in cut_axes(kv["k"], 1) or () if mesh_shape(mesh)[a] > 1]
        attend = local_map(partial(attend, groups=groups),
                           out_placements=pl,
                           in_placements=(placements(P(rows, None, None, None), mesh),
                                          kv["k"].placements, kv["v"].placements),
                           device_mesh=mesh, redistribute_inputs=True)
    return attend(q, kv["k"], kv["v"]) @ params["wo"]


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
