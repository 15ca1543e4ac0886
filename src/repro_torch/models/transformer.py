"""Model assembly for every family of the repo: dense attention (tinyllama,
qwen3, gemma2, h2o-danube), MoE (olmoe, granite-moe), Mamba2 and hybrid
(mamba2, jamba), encoder-decoder (whisper) and vision-language (qwen2-vl),
mirroring ``repro/models/transformer.py``.

* The layer stack is ``n_blocks`` repetitions of the config's ``block``
  pattern. Parameters of pattern position ``i`` are stacked over blocks with
  leading dim ``n_blocks``, the same tree as the JAX package, so converted
  JAX weights drop in; where JAX runs the stack as one ``lax.scan``, the port
  loops over blocks in Python.
* Train/prefill forward (with ``remat``) and the chunked ``lm_loss``,
  single-token decode with KV caches (ring buffers
  for sliding-window layers) and SSM-state caches.
* Whisper: an encoder over precomputed frames (the conv front end is a
  stub, as in JAX), sinusoidal absolute positions, and cross-attention in
  every decoder layer; the decode cache holds each layer's cross K/V.
* qwen2-vl: precomputed patch embeddings replace the first ``nv`` token
  embeddings (the vision tower is a stub, as in JAX), and positions are
  ``(B, 3, S)`` for M-RoPE, a plain ``arange`` in each of the three
  streams unless the caller passes others.
* Decode caches are updated in place (JAX returns new arrays): the cache
  passed to ``decode_step`` is the one returned, with its lengths advanced.
* Prefill of a mamba layer rebuilds the conv tail from the last
  ``ssm_conv - 1`` normed inputs. A prompt shorter than that gets its tail
  zero-padded at the front, as ``ssm._causal_conv`` pads in forward; the JAX
  reference builds a short tail there and its first decode step fails.

The paged serving engine takes decoder-only models: ``check_servable``
refuses an encoder-decoder one.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.sharding import (P, constrain, dp_axes, dp_size, local_part,
                                              mesh_context, placements, replicate, replicated,
                                              whole)
from repro_torch.launch.mesh import mesh_shape
from repro_torch.tree import tree_map
from . import layers as L
from .moe import init_moe, moe_ffn
from .ssm import init_mamba, init_mamba_state, mamba_chunked, mamba_decode_step

KPOS_INVALID = (2 ** 31 - 1) // 2   # empty ring slot: always masked


def _constrain_batch(x, mesh):
    """Pin activations to data-parallel batch sharding (replicated elsewhere),
    JAX's ``with_sharding_constraint`` at each block boundary: ``redistribute``
    to ``Shard(0)`` over the dp axes where they divide the batch. Without a
    mesh, or on a plain tensor, ``x`` as it is."""
    if mesh is None or x.shape[0] % dp_size(mesh) != 0:
        return x
    return constrain(x, mesh, P(dp_axes(mesh), *([None] * (x.dim() - 1))))


def _constrain_seq(x, mesh, cfg: ModelConfig):
    """Sequence-parallel residual layout P(dp, model, None) under
    ``cfg.seq_parallel``, where the axes divide batch and sequence."""
    if mesh is None or not cfg.seq_parallel or x.dim() != 3:
        return x
    tp = mesh_shape(mesh).get("model", 1)
    if x.shape[0] % dp_size(mesh) != 0 or x.shape[1] % tp != 0 or tp <= 1:
        return x
    return constrain(x, mesh, P(dp_axes(mesh), "model", None))


def check_servable(cfg: ModelConfig) -> None:
    """Raise for a model the paged serving engine cannot serve: an
    encoder-decoder one, whose decoder layers cross-attend to the encoder's
    output. The paged decode step has no cross-attention, and neither has
    the JAX engine's (its prefill passes no encoder frames), so such a model
    runs through ``prefill(enc_frames=)`` and ``decode_step`` instead."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the paged serving engine takes decoder-only models; this "
            "encoder-decoder model needs cross-attention, which the paged decode step does "
            "not have (the JAX engine cannot serve it either). Run it through "
            "transformer.prefill(enc_frames=) and transformer.decode_step.")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _init_sublayer(generator, spec: LayerSpec, cfg: ModelConfig, device,
                   cross: bool = False) -> dict:
    p: dict = {"norm": L.init_rmsnorm(cfg.d_model, device)["scale"],
               "attn": (L.init_attention(generator, cfg, device) if spec.kind == "attn"
                        else init_mamba(generator, cfg, device))}
    if cfg.post_norms:
        p["post_norm"] = L.init_rmsnorm(cfg.d_model, device)["scale"]
    if cross and spec.kind == "attn":
        p["cross_norm"] = L.init_rmsnorm(cfg.d_model, device)["scale"]
        p["cross"] = L.init_attention(generator, cfg, device)
    if spec.ffn in ("mlp", "moe"):
        p["ffn_norm"] = L.init_rmsnorm(cfg.d_model, device)["scale"]
        if spec.ffn == "mlp":
            p["mlp"] = L.init_mlp(generator, cfg, device=device)
        else:
            p["moe"] = init_moe(generator, cfg, device)
        if cfg.post_norms:
            p["ffn_post_norm"] = L.init_rmsnorm(cfg.d_model, device)["scale"]
    return p


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stacked_draws(draw, n: int):
    """``n`` calls of ``draw`` (a tree of tensors each), stacked on a new
    leading dim. Each draw is copied into the stacked tensors as it comes
    and then dropped, so the peak is the result and one draw: at full width
    a list of all draws and its stack would need twice the weights."""
    out = None
    for i in range(n):
        tree = draw()
        if out is None:
            out = tree_map(lambda a: a.new_empty((n, *a.shape)), tree)
        tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
        del tree
    return out


def layer_params(tree, l: int):
    """Block ``l``'s slice of a stacked parameter (or cache) tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, l) for k, v in tree.items()}
    return tree[l]


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights on ``device`` with the JAX tree layout, dtypes and
    scales (N(0,1) * d**-0.5 matrices in the config dtype, zero f32 norm
    scales). The numbers differ from ``jax.random``'s: parity with the JAX
    init is statistical only. An encoder-decoder model also gets the cross
    parameters of each decoder attention layer and ``params["encoder"]``
    (its own attention + MLP blocks, stacked over ``encoder_layers``)."""
    dt = getattr(torch, cfg.dtype)
    params: dict = {
        "embed": L.init_normal((cfg.vocab, cfg.d_model), generator, device,
                               cfg.d_model ** -0.5, dt),
        "final_norm": L.init_rmsnorm(cfg.d_model, device)["scale"],
    }
    cross = cfg.encoder_layers > 0
    params["blocks"] = tuple(
        _stacked_draws(lambda: _init_sublayer(generator, spec, cfg, device, cross),
                       cfg.n_blocks)
        for spec in cfg.block)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_normal((cfg.d_model, cfg.vocab), generator, device,
                                          cfg.d_model ** -0.5, dt)
    if cfg.encoder_layers:
        enc_spec = LayerSpec(kind="attn", ffn="mlp")
        params["encoder"] = {
            "blocks": _stacked_draws(lambda: _init_sublayer(generator, enc_spec, cfg, device),
                                     cfg.encoder_layers),
            "final_norm": L.init_rmsnorm(cfg.d_model, device)["scale"],
        }
    return params


class _Tree(nn.Module):
    """A nested dict/tuple of tensors as modules, so ``.to(device)`` and
    ``state_dict()`` work; ``tree()`` gives the dict back."""

    def __init__(self, tree: dict):
        super().__init__()
        self._kinds = {}
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
                self._kinds[k] = "tensor"
            elif isinstance(v, dict):
                self.add_module(k, _Tree(v))
                self._kinds[k] = "dict"
            else:
                self.add_module(k, nn.ModuleList([_Tree(x) for x in v]))
                self._kinds[k] = "tuple"

    def tree(self) -> dict:
        out = {}
        for k, kind in self._kinds.items():
            m = getattr(self, k)
            out[k] = (m if kind == "tensor" else m.tree() if kind == "dict"
                      else tuple(x.tree() for x in m))
        return out


class Transformer(_Tree):
    """Holds the stacked parameters; ``tree()`` is what the functions below
    take as ``params``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    @classmethod
    def random(cls, cfg: ModelConfig, generator: torch.Generator, device=None):
        return cls(cfg, init_params(cfg, generator, device))

    def forward(self, tokens, *, enc_frames=None, vis_embeds=None):
        return forward_logits(self.tree(), tokens, self.cfg, enc_frames=enc_frames,
                              vis_embeds=vis_embeds)[0]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _lookup(embed: DTensor, tokens):
    """``embed[tokens]`` for a DTensor table, under ``local_map``: the whole
    table on every rank (gathered, as FSDP gathers a weight), each rank's
    rows of the batch where the data-parallel axes divide it. The table's
    gradient is then a sum over those axes (``Partial``) and replicated
    over the rest. The lookup stays the plain indexing, whose backward
    DTensor need not shard."""
    mesh = embed.device_mesh
    tokens = replicate(tokens, mesh)
    dp = dp_axes(mesh) if tokens.shape[0] % dp_size(mesh) == 0 else None
    tok_pl = placements(P(dp, *([None] * (tokens.dim() - 1))), mesh)
    out_pl = placements(P(dp, *([None] * tokens.dim())), mesh)
    grad_pl = [Partial() if isinstance(t, Shard) else Replicate() for t in tok_pl]
    return local_map(lambda e, t: e[t], out_placements=out_pl,
                     in_placements=(placements(P(), mesh), tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(embed, tokens)


def token_embeddings(params, tokens, cfg: ModelConfig):
    """The embedding rows of ``tokens`` (B, S) -> (B, S, D), scaled for gemma."""
    embed = params["embed"]
    x = _lookup(embed, tokens) if isinstance(embed, DTensor) else embed[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _add_abs_positions(x, positions, cfg: ModelConfig):
    """Whisper's sinusoidal absolute positions (B, S), computed in f32, cast
    to x's dtype and then added, in JAX's order; other models unchanged."""
    if cfg.rope_theta == 0.0 and cfg.encoder_layers:
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


def embed_tokens(params, tokens, cfg: ModelConfig, vis_embeds=None):
    """Token embeddings of a prompt at positions 0..S-1. ``vis_embeds`` (B,
    nv, D), cast to the embedding dtype, replace the first ``nv`` of them."""
    x = token_embeddings(params, tokens, cfg)
    if vis_embeds is not None:
        nv = vis_embeds.shape[1]
        x = torch.cat([vis_embeds.to(x.dtype), x[:, nv:]], dim=1)
    return _add_abs_positions(x, torch.arange(x.shape[1], device=x.device)[None, :], cfg)


def head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_fn(params, x, cfg: ModelConfig):
    logits = (x @ head_weight(params, cfg)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Forward (train / prefill trunk): loop over blocks
# ---------------------------------------------------------------------------

def apply_ffn(x, p, spec: LayerSpec, cfg: ModelConfig, mesh=None):
    """The sublayer's feed-forward on the residual x. Returns (x, the MoE's
    aux losses, or None for an MLP or no FFN). The MoE has no post-norm, as
    in JAX."""
    if spec.ffn == "mlp":
        h = _constrain_batch(L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps), mesh)
        h = _constrain_batch(L.mlp(h, p["mlp"], cfg.act), mesh)
        if cfg.post_norms:
            h = L.rmsnorm(h, p["ffn_post_norm"], cfg.norm_eps)
        return x + h, None
    if spec.ffn == "moe":
        h = _constrain_batch(L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps), mesh)
        h, losses = moe_ffn(h, p["moe"], cfg, mesh=mesh)
        return x + _constrain_batch(h, mesh), losses
    return x, None


def _apply_sublayer(x, p, spec: LayerSpec, cfg: ModelConfig, *, positions, cross_kv=None,
                    mesh=None):
    """One sublayer (attn or mamba, then whisper's cross-attention over
    ``cross_kv`` = (k, v) where given, then ffn) in train/prefill form.
    Returns (x, aux losses or None)."""
    h = _constrain_batch(L.rmsnorm(x, p["norm"], cfg.norm_eps), mesh)
    if spec.kind == "attn":
        h = L.multihead_attention(h, p["attn"], cfg, positions=positions,
                                  window=spec.window, causal=True, mesh=mesh)
    else:
        h = replicated(mamba_chunked, mesh, h, p["attn"], cfg)
    h = _constrain_batch(h, mesh)
    if cfg.post_norms:
        h = L.rmsnorm(h, p["post_norm"], cfg.norm_eps)
    x = x + h
    if cross_kv is not None:
        h = _constrain_batch(L.rmsnorm(x, p["cross_norm"], cfg.norm_eps), mesh)
        h = L.multihead_attention(h, p["cross"], cfg, positions=None, kv_override=cross_kv,
                                  causal=False, mesh=mesh)
        x = x + _constrain_batch(h, mesh)
    return apply_ffn(x, p, spec, cfg, mesh)


def _positions(b: int, s: int, cfg: ModelConfig, device):
    """Default positions 0..S-1: (B, S), or (B, 3, S) under M-RoPE."""
    pos = torch.arange(s, device=device)
    if cfg.mrope_sections:
        return pos[None, None, :].expand(b, 3, s)
    return pos[None, :].expand(b, s)


def _encoder_forward(params, frames, cfg: ModelConfig, mesh=None):
    """Whisper encoder over precomputed conv frames (B, enc_seq, D):
    non-causal self-attention + MLP blocks, no rope."""
    if frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder model needs enc_frames "
                         f"(B, {cfg.encoder_seq}, {cfg.d_model})")
    pos = torch.arange(frames.shape[1], device=frames.device)[None, :]
    x = frames.to(getattr(torch, cfg.dtype))
    x = _constrain_batch(x + L.sinusoidal_positions(pos, cfg.d_model).to(x.dtype), mesh)
    enc = params["encoder"]
    for l in range(cfg.encoder_layers):
        p = layer_params(enc["blocks"], l)
        x = _constrain_batch(x, mesh)
        h = _constrain_batch(L.rmsnorm(x, p["norm"], cfg.norm_eps), mesh)
        x = x + _constrain_batch(L.multihead_attention(h, p["attn"], cfg, positions=None,
                                                       causal=False, mesh=mesh), mesh)
        h = _constrain_batch(L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps), mesh)
        x = x + _constrain_batch(L.mlp(h, p["mlp"], cfg.act), mesh)
    return L.rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def block_slices(tree, n: int) -> list:
    """The ``n`` per-block slices of a stacked tree, as ``layer_params``
    gives them one at a time, from one ``unbind`` per leaf: under autograd
    the stacked leaf's gradient is one stack of the blocks' gradients, where
    ``n`` separate index views would each add a zero-filled tensor of the
    whole stack."""
    if isinstance(tree, dict):
        per_key = {k: block_slices(v, n) for k, v in tree.items()}
        return [{k: v[l] for k, v in per_key.items()} for l in range(n)]
    return list(torch.unbind(tree))


def forward(params, tokens, cfg: ModelConfig, *, positions=None, enc_frames=None,
            vis_embeds=None, remat: bool | str = True, mesh=None):
    """Trunk forward. Returns (final_hidden (B,S,D), aux losses dict).
    ``enc_frames`` (B, enc_seq, D): whisper's encoder input, required for an
    encoder-decoder model; ``vis_embeds`` (B, nv, D): qwen2-vl's patch
    embeddings (``embed_tokens``).

    ``remat``: each block (one pass of the config's pattern) runs under
    ``torch.utils.checkpoint`` (non-reentrant) while autograd records, as
    JAX's ``jax.checkpoint`` of its scan body: its activations are
    recomputed in the backward pass, attention kernels included. JAX's
    ``remat="dots"`` (the ``dots_saveable`` policy) has no exact PyTorch
    counterpart and raises ``NotImplementedError``.

    ``mesh``: params (and inputs) are DTensors on it (``distributed``); the
    residual stream is pinned to the batch over the data-parallel axes at
    each block boundary (``_constrain_batch``), DTensor propagates the rest,
    and attention and the MoE run under ``local_map``."""
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (JAX's jax.checkpoint_policies.dots_saveable: keep matmul "
            "outputs, recompute the rest) has no counterpart in the port; use remat=True "
            "or False")
    with mesh_context(mesh):
        b, s = tokens.shape
        if positions is None:
            positions = _positions(b, s, cfg, tokens.device)
        x = embed_tokens(params, tokens, cfg, vis_embeds)
        cross = (encode_cross_kv(params, enc_frames, cfg, mesh) if cfg.encoder_layers
                 else None)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if mesh is not None:
            zero = replicate(zero, mesh)
        blocks = [block_slices(tree, cfg.n_blocks) for tree in params["blocks"]]

        def block(x, lb, z, l):
            with mesh_context(mesh):       # again in the backward's recompute
                x = (_constrain_seq(x, mesh, cfg) if cfg.seq_parallel
                     else _constrain_batch(x, mesh))
                for i, spec in enumerate(cfg.block):
                    x, losses = _apply_sublayer(x, blocks[i][l], spec, cfg,
                                                positions=positions,
                                                cross_kv=_layer_kv(cross, l), mesh=mesh)
                    if losses is not None:
                        lb, z = lb + losses["lb"], z + losses["z"]
            return x, lb, z

        x = _constrain_batch(x, mesh)
        lb = z = zero
        for l in range(cfg.n_blocks):
            if remat and torch.is_grad_enabled():
                x, lb, z = checkpoint(block, x, lb, z, l, use_reentrant=False)
            else:
                x, lb, z = block(x, lb, z, l)
        return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), {"lb": lb, "z": z}


def forward_logits(params, tokens, cfg: ModelConfig, **kw):
    """Materialized logits — tests and small configs."""
    x, aux = forward(params, tokens, cfg, **kw)
    return logits_fn(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Loss (chunked over the sequence so (B, S, vocab) is never held)
# ---------------------------------------------------------------------------

def lm_loss(params, cfg: ModelConfig, hidden, labels, mask=None, seq_chunk: int = 1024,
            mesh=None):
    """Masked mean cross-entropy over the vocab, ``labels`` (B, S) int.

    JAX's rule: chunks of ``c = min(seq_chunk, S)`` positions, one chunk of
    S when c does not divide S. Each chunk's f32 logits (through
    ``head_weight``, softcapped for gemma2) live only inside a
    ``torch.utils.checkpoint``, as under JAX's ``jax.checkpoint``, and are
    recomputed in the backward pass. Divides by ``max(mask.sum(), 1)``.
    With a ``mesh`` each chunk's logits are gathered over the vocab
    (replicated over ``model``, the batch over the data-parallel axes where
    they divide it) before the log-sum-exp and the target's pick."""
    b, s, _ = hidden.shape
    with mesh_context(mesh):
        w = head_weight(params, cfg)
        hidden = _constrain_batch(hidden, mesh)
        c = min(seq_chunk, s)
        if s % c:
            c = s
        if mask is None:
            mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
        mask = mask.float()
        labels = labels.long()
        dp = None if mesh is None or b % dp_size(mesh) else dp_axes(mesh)

        def chunk_sum(xc, lc, mc):
            with mesh_context(mesh):       # again in the backward's recompute
                logits = (xc @ w).float()                               # (B, c, V)
                if mesh is not None:
                    logits = constrain(logits, mesh, P(dp, None, None))
                if cfg.logit_softcap:
                    logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
                lse = torch.logsumexp(logits, dim=-1)
                tgt = torch.gather(logits, -1, lc[..., None])[..., 0]
                return ((lse - tgt) * mc).sum()

        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        if mesh is not None:
            total = replicate(total, mesh)
        for c0 in range(0, s, c):
            sl = slice(c0, c0 + c)
            total = total + checkpoint(chunk_sum, hidden[:, sl], labels[:, sl], mask[:, sl],
                                       use_reentrant=False)
        loss = total / mask.sum().clamp_min(1.0)
        return loss if mesh is None else constrain(loss, mesh, P())


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    lengths: torch.Tensor    # (B,) tokens already in cache
    layers: tuple            # per pattern position, stacked over blocks: {"k","v","kpos"}
                             # (attention) or {"conv_x","conv_bc","ssm"} (mamba)
    cross: Any = None        # whisper: {"k","v"}: (n_layers, B, enc_seq, KV, hd)


def _attn_cache_cap(spec: LayerSpec, max_seq: int) -> int:
    return min(spec.window, max_seq) if spec.window else max_seq


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Zero mamba decode state of ``batch`` rows (``ssm.init_mamba_state``),
    stacked over n_blocks."""
    st = init_mamba_state(batch, cfg, device=device)
    return {k: a[None].repeat(cfg.n_blocks, *([1] * a.dim())) for k, a in st.items()}


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
                      mesh=None) -> DecodeCache:
    """Zero caches on ``device``. With a ``mesh`` they are this rank's: its
    KV heads (``layers.local_kv_heads``), every batch row, as the mesh
    routes of ``decode_step`` and ``prefill`` read and write them."""
    dt = getattr(torch, cfg.dtype)
    kvh = L.local_kv_heads(cfg.n_kv_heads, mesh)
    nb = cfg.n_blocks
    layer_caches = []
    for spec in cfg.block:
        if spec.kind != "attn":
            layer_caches.append(init_mamba_cache(cfg, batch, device))
            continue
        cap = _attn_cache_cap(spec, max_seq)
        shape = (nb, batch, cap, kvh, cfg.head_dim)
        layer_caches.append({
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "kpos": torch.full((nb, batch, cap), KPOS_INVALID, dtype=torch.int32,
                               device=device),
        })
    cross = None
    if cfg.encoder_layers:
        shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        cross = {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
    return DecodeCache(lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
                       layers=tuple(layer_caches), cross=cross)


def encode_cross_kv(params, enc_frames, cfg: ModelConfig, mesh=None) -> dict:
    """Whisper: run the encoder once, project K/V for every decoder layer.

    Returns {"k","v"}: (n_layers, B, enc_seq, KV, hd). Cross-attention
    assumes a homogeneous decoder block (whisper: block = (attn,)), in
    ``forward`` and ``prefill`` too, which take their cross K/V from here."""
    if len(cfg.block) != 1 or cfg.block[0].kind != "attn":
        raise NotImplementedError("cross-attn assumes homogeneous decoder block")
    enc_out = _encoder_forward(params, enc_frames, cfg, mesh)
    kv = [L.project_kv(enc_out, layer_params(params["blocks"][0]["cross"], l), cfg,
                       positions=None) for l in range(cfg.n_blocks)]
    return {"k": torch.stack([k for k, _ in kv]), "v": torch.stack([v for _, v in kv])}


def _layer_kv(cross, l: int):
    """Block ``l``'s (k, v) of ``encode_cross_kv``'s output, or None."""
    return None if cross is None else (cross["k"][l], cross["v"][l])


# ---------------------------------------------------------------------------
# Decode step (one new token per sequence)
# ---------------------------------------------------------------------------

def _decode_attn_sublayer(x, p, cfg: ModelConfig, cache, lengths, positions, mesh=None):
    """x: (B,1,D). cache: {"k","v","kpos"} of THIS layer, written in place.
    With a ``mesh`` the cache write and the attention run under
    ``local_map`` on this rank's heads, every row (the cache holds them,
    ``init_decode_cache(mesh=)``)."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.split_heads(x @ p["wq"], h, hd)
    k = L.split_heads(x @ p["wk"], kvh, hd)
    v = L.split_heads(x @ p["wv"], kvh, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    def attend(q, k, v):
        cap = cache["k"].shape[1]
        slot = (lengths % cap).long()
        bidx = torch.arange(b, device=q.device)
        cache["k"][bidx, slot] = k[:, 0]
        cache["v"][bidx, slot] = v[:, 0]
        cache["kpos"][bidx, slot] = lengths
        return L.decode_attention(q, cache["k"], cache["v"], lengths=lengths + 1,
                                  softcap=cfg.attn_softcap, kpos=cache["kpos"])

    if mesh is not None and isinstance(q, DTensor):
        pl = L.head_placements(mesh, None, kvh)
        attend = local_map(attend, out_placements=pl, in_placements=(pl, pl, pl),
                           device_mesh=mesh, redistribute_inputs=True)
    return attend(q, k, v) @ p["wo"]


def decode_step(params, tokens, cache: DecodeCache, cfg: ModelConfig, *, positions=None,
                mesh=None):
    """tokens: (B, 1) -> (logits (B,1,V), cache). The cache is updated in
    place; the returned one shares its tensors, with lengths + 1. Default
    positions are ``lengths``: (B, 1), or (B, 3, 1) under M-RoPE; whisper
    adds its absolute position there and cross-attends to ``cache.cross``.

    With a ``mesh`` (params DTensors, the cache this rank's,
    ``init_decode_cache(mesh=)``) the residual is pinned to the batch over
    the data-parallel axes at each block, attention and the MoE run under
    ``local_map``, the Mamba2 step on every rank whole; the logits come
    back plain and whole."""
    b = tokens.shape[0]
    lengths = cache.lengths
    if positions is None:
        positions = lengths[:, None]
        if cfg.mrope_sections:
            positions = lengths[:, None, None].expand(b, 3, 1)
    with mesh_context(mesh):
        x = _add_abs_positions(token_embeddings(params, tokens, cfg), lengths[:, None], cfg)
        for l in range(cfg.n_blocks):
            x = _constrain_batch(x, mesh)
            for i, spec in enumerate(cfg.block):
                p = layer_params(params["blocks"][i], l)
                layer_cache = layer_params(cache.layers[i], l)
                h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
                if spec.kind == "attn":
                    h = _decode_attn_sublayer(h, p["attn"], cfg, layer_cache, lengths,
                                              positions, mesh)
                else:
                    h, new = replicated(mamba_decode_step, mesh, h, layer_cache, p["attn"],
                                        cfg)
                    for k, v in new.items():
                        layer_cache[k].copy_(local_part(v))
                if cfg.post_norms:
                    h = L.rmsnorm(h, p["post_norm"], cfg.norm_eps)
                x = x + h
                if cache.cross is not None:
                    h = L.rmsnorm(x, p["cross_norm"], cfg.norm_eps)
                    h = L.decode_cross_attention(h, p["cross"], cfg,
                                                 {"k": cache.cross["k"][l],
                                                  "v": cache.cross["v"][l]})
                    x = x + h
                x, _ = apply_ffn(x, p, spec, cfg, mesh)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = whole(logits_fn(params, x, cfg))
    return logits, DecodeCache(lengths=lengths + 1, layers=cache.layers, cross=cache.cross)


# ---------------------------------------------------------------------------
# Prefill: trunk forward + cache construction
# ---------------------------------------------------------------------------

def _conv_tail(h, p, cfg: ModelConfig) -> dict:
    """The decode state's conv inputs: the last ``ssm_conv - 1`` normed
    inputs through ``in_x``/``in_bc``, in the config dtype. A shorter prompt
    is zero-padded at the front, as ``_causal_conv`` pads in forward (the
    JAX reference keeps the short tail, and its first decode step fails)."""
    cw1 = cfg.ssm_conv - 1
    tail = h[:, -cw1:, :]
    pad = cw1 - tail.shape[1]
    dt = getattr(torch, cfg.dtype)
    return {name: F.pad(tail @ p[w], (0, 0, pad, 0)).to(dt)
            for name, w in (("conv_x", "in_x"), ("conv_bc", "in_bc"))}


def prefill(params, tokens, cfg: ModelConfig, max_seq: int, *, positions=None,
            enc_frames=None, vis_embeds=None, mesh=None):
    """Process the prompt, build the decode cache. Returns (last_logits, cache).

    For whisper the encoder runs once: ``encode_cross_kv``'s K/V feed the
    prefill's cross-attention and become the cache's. JAX runs the encoder
    twice, in its prefill and again inside its ``encode_cross_kv``; the
    numbers are the same, the encoder work half.

    With a ``mesh`` the forward is ``forward``'s mesh route and the cache
    this rank's (``init_decode_cache(mesh=)``): its KV heads, every row; a
    Mamba2 state and the cross K/V whole. The logits come back plain and
    whole."""
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = _positions(b, s, cfg, dev)
    kvh = L.local_kv_heads(cfg.n_kv_heads, mesh)
    with mesh_context(mesh):
        x = _constrain_batch(embed_tokens(params, tokens, cfg, vis_embeds), mesh)
        cross = (encode_cross_kv(params, enc_frames, cfg, mesh) if cfg.encoder_layers
                 else None)
        caches: list[list[dict]] = [[] for _ in cfg.block]
        for l in range(cfg.n_blocks):
            x = _constrain_batch(x, mesh)
            for i, spec in enumerate(cfg.block):
                p = layer_params(params["blocks"][i], l)
                hpre = L.rmsnorm(x, p["norm"], cfg.norm_eps)
                if spec.kind != "attn":
                    h, state = replicated(mamba_chunked, mesh, hpre, p["attn"], cfg,
                                          return_state=True)
                    tail = replicated(_conv_tail, mesh, hpre, p["attn"], cfg)
                    caches[i].append({**{k: local_part(t) for k, t in tail.items()},
                                      "ssm": local_part(state)})
                    if cfg.post_norms:
                        h = L.rmsnorm(h, p["post_norm"], cfg.norm_eps)
                    x, _ = apply_ffn(x + h, p, spec, cfg, mesh)
                    continue
                k, v = (L.local_heads(t, mesh, cfg.n_kv_heads)
                        for t in L.project_kv(hpre, p["attn"], cfg, positions))
                cap = _attn_cache_cap(spec, max_seq)
                kc = torch.zeros((b, cap, kvh, cfg.head_dim), dtype=k.dtype, device=dev)
                vc = torch.zeros_like(kc)
                kp = torch.full((b, cap), KPOS_INVALID, dtype=torch.int32, device=dev)
                w = min(s, cap)
                pos = s - w + torch.arange(w, device=dev)
                sl = pos % cap
                kc[:, sl] = k[:, -w:]
                vc[:, sl] = v[:, -w:]
                kp[:, sl] = pos.to(torch.int32)[None, :]
                caches[i].append({"k": kc, "v": vc, "kpos": kp})
                x, _ = _apply_sublayer(x, p, spec, cfg, positions=positions,
                                       cross_kv=_layer_kv(cross, l), mesh=mesh)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = whole(logits_fn(params, x[:, -1:, :], cfg))
        if cross is not None:
            cross = {k: whole(t) for k, t in cross.items()}
    cache = DecodeCache(lengths=torch.full((b,), s, dtype=torch.int32, device=dev),
                        layers=tuple(_stack(c) for c in caches), cross=cross)
    return logits, cache
