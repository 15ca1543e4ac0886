"""Data plane for paged serving: one decode step over the page pool.

Mirrors ``models/transformer.decode_step``, but attention layers read and
write the shared page pool through a per-sequence page table instead of
dense per-sequence ring buffers. Attention always goes through
``kernels.ops.paged_attention``: the Hopper kernel on the card, its plain
version for CPU tensors. Mamba layers keep their conv/ssm state per batch
row (the "pinned pages" of the JAX design), and MoE layers route all B rows
of the step, active or not, as JAX does: an inactive row takes expert
capacity too.

The pools are updated in place (the JAX step returns new, immutable pools).
Background offload threads read pages out of the same tensors, so the engine
runs each step under its pools lock; see ``engine.ServeEngine``.

With a ``mesh`` (params DTensors, ``param_specs(fsdp=False)``) the pools are
this rank's: its KV heads (``layers.local_kv_heads``: a share of them, or
under ``layers.head_split`` "q" the one KV head its query heads read), every
page. The K/V write and the paged kernel run under ``local_map`` on a
rank's query heads and those KV heads, the MoE through ``moe_ffn(mesh=)``,
the Mamba2 step on a rank's heads (the state pools are DTensors cut by
heads, ``transformer.init_mamba_cache(mesh=)``), every row.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import local_part, mesh_context, whole
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.ssm import mamba_decode_step


def init_pools(cfg: ModelConfig, *, num_pages: int, page_size: int, max_batch: int,
               device=None, mesh=None):
    """Per block position, stacked over n_blocks: K/V pools (n_blocks,
    num_pages, page_size, KV, hd) in the config dtype for an attention
    position, per-row state pools {"conv_x", "conv_bc", "ssm"} (n_blocks,
    max_batch, ...) for a mamba position (``transformer.init_mamba_cache``).
    With a ``mesh``, KV is this rank's share (``layers.local_kv_heads``) and
    the mamba state DTensors cut by heads."""
    dt = getattr(torch, cfg.dtype)
    kvh = L.local_kv_heads(cfg.n_heads, cfg.n_kv_heads, mesh)
    shape = (cfg.n_blocks, num_pages, page_size, kvh, cfg.head_dim)
    pools = []
    for spec in cfg.block:
        if spec.kind == "attn":
            pools.append({"k": torch.zeros(shape, dtype=dt, device=device),
                          "v": torch.zeros(shape, dtype=dt, device=device)})
        else:
            pools.append(T.init_mamba_cache(cfg, max_batch, device, mesh))
    return tuple(pools)


def make_paged_decode_step(cfg: ModelConfig, *, page_size: int, mesh=None):
    """Returns ``step(params, pools, tokens, lengths, page_table, rows) ->
    logits (B, 1, V)``. An encoder-decoder model raises
    (``transformer.check_servable``).

    tokens: (B, 1); lengths: (B,) int32 tokens already in the pool;
    page_table: (B, max_pages) int32 pool ids; rows: (n,) int64 indices of the
    active rows. Only the active rows write their new K/V, at
    ``(page_table[b, len // page], len % page)``, and their new mamba state
    (JAX's ``where(active, new, old)``: a preempted or empty row's state does
    not move); every row attends, over ``lengths + 1`` keys (an inactive row
    reads the scratch page its table points at, and its output is ignored).
    Positions are ``lengths``: (B, 1), or (B, 3, 1) under M-RoPE, as JAX.
    With a ``mesh`` the logits come back plain and whole on every rank.
    """
    T.check_servable(cfg)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def attn_sublayer(x, p, k_pool, v_pool, rows, pids, offs, page_table, lengths1,
                      positions):
        b = x.shape[0]
        q = L.split_heads(x @ p["wq"], h, hd)
        k = L.split_heads(x @ p["wk"], kvh, hd)
        v = L.split_heads(x @ p["wv"], kvh, hd)
        if cfg.qk_norm:
            q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
            k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
        if cfg.rope_theta:
            q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        q = L.scale_queries(q, cfg)

        def attend(q, k, v):
            k, v = (L.kv_for_rank(t, mesh, h, kvh) for t in (k, v))
            k_pool[pids, offs] = k[rows, 0]
            v_pool[pids, offs] = v[rows, 0]
            out = ops.paged_attention(q[:, 0].contiguous(), k_pool, v_pool, page_table,
                                      lengths1, softcap=cfg.attn_softcap)
            return out.reshape(b, 1, -1)

        if mesh is not None and isinstance(q, DTensor):
            q_pl, kv_pl, _ = L.head_placements(mesh, None, h, kvh)
            attend = local_map(attend, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                               device_mesh=mesh, redistribute_inputs=True)
        return attend(q, k, v) @ p["wo"]

    def step(params, pools, tokens, lengths, page_table, rows):
        positions = lengths[:, None]
        if cfg.mrope_sections:
            positions = lengths[:, None, None].expand(-1, 3, 1)
        lengths1 = lengths + 1
        cur = lengths[rows].long()
        pids = page_table[rows, cur // page_size].long()
        offs = cur % page_size
        with mesh_context(mesh):
            x = T.token_embeddings(params, tokens, cfg)
            for l in range(cfg.n_blocks):
                for i, spec in enumerate(cfg.block):
                    p = T.layer_params(params["blocks"][i], l)
                    hh = L.rmsnorm(x, p["norm"], cfg.norm_eps)
                    if spec.kind == "attn":
                        hh = attn_sublayer(hh, p["attn"], pools[i]["k"][l], pools[i]["v"][l],
                                           rows, pids, offs, page_table, lengths1, positions)
                    else:
                        state = T.layer_params(pools[i], l)
                        hh, new = mamba_decode_step(hh, state, p["attn"], cfg)
                        for k, v in new.items():
                            local_part(state[k])[rows] = local_part(v)[rows]
                    if cfg.post_norms:
                        hh = L.rmsnorm(hh, p["post_norm"], cfg.norm_eps)
                    x, _ = T.apply_ffn(T.residual(x, hh, cfg), p, spec, cfg, mesh)
            x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
            return whole(T.logits_fn(params, x, cfg))

    return step
