"""Data plane for paged serving: one decode step over the page pool.

Mirrors ``models/transformer.decode_step``, but attention layers read and
write the shared page pool through a per-sequence page table instead of
dense per-sequence ring buffers. Attention always goes through
``kernels.ops.paged_attention``: the Hopper kernel on the card, its plain
version for CPU tensors.

The pools are updated in place (the JAX step returns new, immutable pools).
Background offload threads read pages out of the same tensors, so the engine
runs each step under its pools lock; see ``engine.ServeEngine``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_pools(cfg: ModelConfig, *, num_pages: int, page_size: int, device=None):
    """Per block position, K/V pools stacked over n_blocks:
    (n_blocks, num_pages, page_size, KV, hd) in the config dtype."""
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.n_blocks, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return tuple({"k": torch.zeros(shape, dtype=dt, device=device),
                  "v": torch.zeros(shape, dtype=dt, device=device)} for _ in cfg.block)


def make_paged_decode_step(cfg: ModelConfig, *, page_size: int):
    """Returns ``step(params, pools, tokens, lengths, page_table, rows) ->
    logits (B, 1, V)``.

    tokens: (B, 1); lengths: (B,) int32 tokens already in the pool;
    page_table: (B, max_pages) int32 pool ids; rows: (n,) int64 indices of the
    active rows. Only the active rows write their new K/V, at
    ``(page_table[b, len // page], len % page)``; every row attends, over
    ``lengths + 1`` keys (an inactive row reads the scratch page its table
    points at, and its output is ignored).
    """
    T.check_supported(cfg)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def attn_sublayer(x, p, k_pool, v_pool, rows, pids, offs, page_table, lengths1,
                      positions):
        b = x.shape[0]
        q = (x @ p["wq"]).reshape(b, 1, h, hd)
        k = (x @ p["wk"]).reshape(b, 1, kvh, hd)
        v = (x @ p["wv"]).reshape(b, 1, kvh, hd)
        if cfg.qk_norm:
            q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
            k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
        if cfg.rope_theta:
            q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        k_pool[pids, offs] = k[rows, 0]
        v_pool[pids, offs] = v[rows, 0]
        out = ops.paged_attention(q[:, 0].contiguous(), k_pool, v_pool, page_table,
                                  lengths1, softcap=cfg.attn_softcap)
        return out.reshape(b, 1, h * hd) @ p["wo"]

    def step(params, pools, tokens, lengths, page_table, rows):
        positions = lengths[:, None]
        lengths1 = lengths + 1
        cur = lengths[rows].long()
        pids = page_table[rows, cur // page_size].long()
        offs = cur % page_size
        x = T.embed_tokens(params, tokens, cfg)
        for l in range(cfg.n_blocks):
            for i, spec in enumerate(cfg.block):
                p = T.layer_params(params["blocks"][i], l)
                hh = L.rmsnorm(x, p["norm"], cfg.norm_eps)
                hh = attn_sublayer(hh, p["attn"], pools[i]["k"][l], pools[i]["v"][l],
                                   rows, pids, offs, page_table, lengths1, positions)
                if cfg.post_norms:
                    hh = L.rmsnorm(hh, p["post_norm"], cfg.norm_eps)
                x = T.apply_ffn(x + hh, p, spec, cfg)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return T.logits_fn(params, x, cfg)

    return step
