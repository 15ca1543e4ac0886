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
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.sharding import (P, cache_specs, constrain, cut_axes, dp_axes,
                                              dp_size, grad_in_placements, local_part,
                                              mesh_context, placements, replicate, whole)
from repro_torch.launch.mesh import mesh_shape
from repro_torch.tree import tree_map
from . import layers as L
from .moe import init_moe, moe_ffn
from .ssm import init_mamba, init_mamba_state, mamba_chunked, mamba_decode_step, mesh_layout

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
    """The embedding rows of ``tokens`` (B, S) -> (B, S, D), scaled for gemma
    and by ``cfg.embedding_multiplier``."""
    embed = params["embed"]
    x = _lookup(embed, tokens) if isinstance(embed, DTensor) else embed[tokens]
    if cfg.embed_scale:
        # a host number rounded to x's dtype: no device tensor built from a
        # host value, so a CUDA graph can capture the step
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
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
    """The output projection (D, V): ``lm_head``, or the embedding table's
    transpose when they are tied. A tied table's gradient from the head
    comes back in the table's own placements (``grad_in_placements``), as
    its lookup's does, so the two add without a redistribute (DTensor in
    torch 2.11 picks Shard -> Partial for that sum and cannot do it)."""
    return grad_in_placements(params["embed"]).T if cfg.tie_embeddings else params["lm_head"]


def _scale_logits(logits, cfg: ModelConfig):
    """f32 logits over ``cfg.logits_divisor``, then gemma2's softcap."""
    if cfg.logits_divisor != 1.0:
        logits = logits / cfg.logits_divisor
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def logits_fn(params, x, cfg: ModelConfig):
    return _scale_logits((x @ head_weight(params, cfg)).float(), cfg)


def residual(x, h, cfg: ModelConfig):
    """``x + h``, the sublayer output ``h`` times ``cfg.residual_multiplier``
    first where it is not 1."""
    if cfg.residual_multiplier != 1.0:
        h = h * cfg.residual_multiplier
    return x + h




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
        return residual(x, h, cfg), None
    if spec.ffn == "moe":
        h = _constrain_batch(L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps), mesh)
        h, losses = moe_ffn(h, p["moe"], cfg, mesh=mesh)
        return residual(x, _constrain_batch(h, mesh), cfg), losses
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
        h = mamba_chunked(h, p["attn"], cfg, mesh=mesh)
    h = _constrain_batch(h, mesh)
    if cfg.post_norms:
        h = L.rmsnorm(h, p["post_norm"], cfg.norm_eps)
    x = residual(x, h, cfg)
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


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
         torch.ops.repro_torch.flash_attention_lse.default}


def dots_saveable():
    """The selective checkpoint of ``forward(remat="dots")``, JAX's
    ``jax.checkpoint_policies.dots_saveable``: the outputs of ``mm``,
    ``addmm`` and ``bmm`` (every projection, and the plain attention's two
    products, ``dot_general``s in JAX) and of the flash operator (its
    output and log-sum-exps, ``flash_attention_lse``) are saved,
    everything else is recomputed in the backward pass."""
    return create_selective_checkpoint_contexts(_save_dots)


def forward(params, tokens, cfg: ModelConfig, *, positions=None, enc_frames=None,
            vis_embeds=None, remat: bool | str = True, mesh=None):
    """Trunk forward. Returns (final_hidden (B,S,D), aux losses dict).
    ``enc_frames`` (B, enc_seq, D): whisper's encoder input, required for an
    encoder-decoder model; ``vis_embeds`` (B, nv, D): qwen2-vl's patch
    embeddings (``embed_tokens``).

    ``remat``: each sublayer (one spec of the config's pattern: its mixer
    and its feed-forward) runs under ``torch.utils.checkpoint``
    (non-reentrant) while autograd records: its activations are recomputed
    in the backward pass, attention kernels included, so the backward holds
    the sublayers' inputs and one sublayer's activations at a time. JAX
    checkpoints its scan body, a whole block; for a block of one sublayer
    the two are the same, and the values are the same for any block.
    ``remat="dots"`` is JAX's ``dots_saveable`` policy as a selective
    checkpoint (``dots_saveable``): the outputs of the matrix products and
    of the flash operator are kept, the elementwise chains recomputed.

    ``mesh``: params (and inputs) are DTensors on it (``distributed``); the
    residual stream is pinned to the batch over the data-parallel axes at
    each block boundary (``_constrain_batch``), DTensor propagates the rest,
    and attention and the MoE run under ``local_map``."""
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

        def sublayer(x, lb, z, l, i):
            with mesh_context(mesh):       # again in the backward's recompute
                if i == 0:                 # at each block boundary
                    x = (_constrain_seq(x, mesh, cfg) if cfg.seq_parallel
                         else _constrain_batch(x, mesh))
                x, losses = _apply_sublayer(x, blocks[i][l], cfg.block[i], cfg,
                                            positions=positions,
                                            cross_kv=_layer_kv(cross, l), mesh=mesh)
                if losses is not None:
                    lb, z = lb + losses["lb"], z + losses["z"]
            return x, lb, z

        x = _constrain_batch(x, mesh)
        lb = z = zero
        for l in range(cfg.n_blocks):
            for i in range(len(cfg.block)):
                if remat and torch.is_grad_enabled():
                    ctx = {"context_fn": dots_saveable} if remat == "dots" else {}
                    x, lb, z = checkpoint(sublayer, x, lb, z, l, i, use_reentrant=False,
                                          **ctx)
                else:
                    x, lb, z = sublayer(x, lb, z, l, i)
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
    ``head_weight``, over ``logits_divisor``, softcapped for gemma2) live only inside a
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
                logits = _scale_logits(logits, cfg)
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


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None, mesh=None) -> dict:
    """Zero mamba decode state of ``batch`` rows (``ssm.init_mamba_state``),
    stacked over n_blocks. With a ``mesh`` (the paged step's per-row state
    pools) DTensors holding every row and, where ``model`` divides them,
    a rank's heads and ``d_inner`` channels (``ssm.mesh_layout``)."""
    st = init_mamba_state(batch, cfg, device=device)
    if mesh is None:
        return {k: a[None].repeat(cfg.n_blocks, *([1] * a.dim())) for k, a in st.items()}
    _, tp = mesh_layout(mesh, None, cfg)
    specs = {"conv_x": P(None, None, None, tp), "conv_bc": P(), "ssm": P(None, None, tp)}
    return {k: _zeros_placed((cfg.n_blocks, *a.shape), a.dtype, specs[k], mesh, device)
            for k, a in st.items()}


def _shard_shape(shape, spec, mesh) -> tuple:
    """The local shape of a tensor of ``shape`` placed by ``spec``."""
    sizes = mesh_shape(mesh)
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        for a in () if entry is None else (entry if isinstance(entry, tuple) else (entry,)):
            n //= sizes[a]
        out.append(n)
    return tuple(out)


def _placed(local, spec, shape, mesh):
    """A rank's shard ``local`` of a tensor of ``shape`` placed by ``spec``,
    as the DTensor (no communication)."""
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _zeros_placed(shape, dtype, spec, mesh, device, fill=0):
    local = torch.full(_shard_shape(shape, spec, mesh), fill, dtype=dtype, device=device)
    return _placed(local, spec, shape, mesh)


def _coord(mesh, entry) -> tuple[int, int]:
    """(this rank's index, count) over the mesh axes of a spec entry (None,
    a name or names in mesh order): how a dim cut over them is split; (0, 1)
    for None, without reading the mesh."""
    idx, n = 0, 1
    for a in () if entry is None else (entry if isinstance(entry, tuple) else (entry,)):
        size = mesh_shape(mesh)[a]
        idx, n = idx * size + mesh.get_local_rank(a), n * size
    return idx, n


def cache_layout(cfg: ModelConfig, batch: int, max_seq: int, mesh) -> tuple:
    """(shapes, specs): the whole decode cache's leaves as meta tensors and
    their ``cache_specs`` on ``mesh``."""
    struct = init_decode_cache(cfg, batch, max_seq, device="meta")
    return struct, cache_specs(struct, mesh, batch)


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
                      mesh=None) -> DecodeCache:
    """Zero caches on ``device``. With a ``mesh`` each leaf is a DTensor
    placed by ``cache_specs``, as JAX's cache is sharded: attention K/V and
    ``kpos`` with the batch over the data-parallel axes and the sequence
    over ``model`` (at a batch they do not divide, the sequence over every
    axis), the Mamba2 state by batch and heads, the conv tails by batch
    and channels, whisper's cross K/V by batch; a rank allocates its shard
    only. ``lengths`` stays a plain tensor, the same on every rank."""
    if mesh is not None:
        struct, specs = cache_layout(cfg, batch, max_seq, mesh)
        fill = lambda t: KPOS_INVALID if t.dtype == torch.int32 else 0
        layers = tuple({k: _zeros_placed(t.shape, t.dtype, sp[k], mesh, device, fill(t))
                        for k, t in c.items()} for c, sp in zip(struct.layers, specs.layers))
        cross = (None if struct.cross is None else
                 {k: _zeros_placed(t.shape, t.dtype, specs.cross[k], mesh, device)
                  for k, t in struct.cross.items()})
        return DecodeCache(lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
                           layers=layers, cross=cross)
    dt = getattr(torch, cfg.dtype)
    kvh = cfg.n_kv_heads
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

def _write_and_attend(q, k, v, kc, vc, kp, lens, s_idx: int, cut: int, groups,
                      softcap: float):
    """One decode step's cache write and attention on a shard of a layer's
    cache: kc, vc (B, cap_loc, KV, hd) and kp (B, cap_loc), the ``s_idx``-th
    of ``cut`` slices of the ring's slots, for rows whose lengths are
    ``lens``. The new token is written where its ring slot ``lens % cap``
    lies in these slots; with the whole ring here (``cut`` 1) the attention
    is ``layers.decode_attention``, else each rank attends over its slots
    (``layers.decode_attention_partial``) and meets the ranks of ``groups``
    that hold the row's other slots in ``layers.combine_partials``. The
    unsharded cache is the shard (0, 1)."""
    b, cap_loc = kc.shape[0], kc.shape[1]
    at = (lens % (cap_loc * cut)).long()
    bidx = torch.arange(b, device=q.device)
    k, v, pos = k[:, 0], v[:, 0], lens
    if cut > 1:               # a row whose slot another rank holds keeps its values
        at = at - s_idx * cap_loc
        mine = (at >= 0) & (at < cap_loc)
        at = at.clamp(0, cap_loc - 1)
        k = torch.where(mine[:, None, None], k, kc[bidx, at])
        v = torch.where(mine[:, None, None], v, vc[bidx, at])
        pos = torch.where(mine, pos, kp[bidx, at])
    kc[bidx, at] = k
    vc[bidx, at] = v
    kp[bidx, at] = pos
    if cut == 1:
        return L.decode_attention(q, kc, vc, lengths=lens + 1, softcap=softcap, kpos=kp)
    o, m, l = L.decode_attention_partial(q, kc, vc, lengths=lens + 1, softcap=softcap,
                                         kpos=kp)
    return L.combine_partials(o, m, l, groups).reshape(b, 1, -1).to(q.dtype)


def _mesh_decode_attend(q, k, v, cache, lengths, cfg: ModelConfig, mesh):
    """``_write_and_attend`` on a cache placed by ``cache_specs`` (a layer's
    leaves: (B, cap, KV, hd) DTensors cut by rows and sequence slots), under
    ``local_map``: each rank takes q, k and v of its rows with every head
    and works on its shard. The output holds a rank's rows, replicated over
    the rest."""
    kc = cache["k"]
    rows, seq = cut_axes(kc, 0), cut_axes(kc, 1)
    groups = [mesh.get_group(a) for a in seq or () if mesh_shape(mesh)[a] > 1]
    row_pl = placements(P(rows, None, None, None), mesh)

    def attend(q, k, v, kc, vc, kp):
        b_loc = kc.shape[0]
        r, _ = _coord(mesh, rows)
        return _write_and_attend(q, k, v, kc, vc, kp, lengths[r * b_loc:(r + 1) * b_loc],
                                 *_coord(mesh, seq), groups, cfg.attn_softcap)

    return local_map(attend, out_placements=row_pl,
                     in_placements=(row_pl, row_pl, row_pl, kc.placements,
                                    cache["v"].placements, cache["kpos"].placements),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, kc, cache["v"], cache["kpos"])


def _decode_attn_sublayer(x, p, cfg: ModelConfig, cache, lengths, positions, mesh=None):
    """x: (B,1,D). cache: {"k","v","kpos"} of THIS layer, written in place.
    With a ``mesh`` (the cache ``init_decode_cache(mesh=)``'s or
    ``prefill(mesh=)``'s) through ``_mesh_decode_attend``."""
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
    q = L.scale_queries(q, cfg)
    if mesh is not None and isinstance(q, DTensor):
        return _mesh_decode_attend(q, k, v, cache, lengths, cfg, mesh) @ p["wo"]
    return _write_and_attend(q, k, v, cache["k"], cache["v"], cache["kpos"], lengths, 0, 1,
                             (), cfg.attn_softcap) @ p["wo"]


def decode_step(params, tokens, cache: DecodeCache, cfg: ModelConfig, *, positions=None,
                mesh=None):
    """tokens: (B, 1) -> (logits (B,1,V), cache). The cache is updated in
    place; the returned one shares its tensors, with lengths + 1. Default
    positions are ``lengths``: (B, 1), or (B, 3, 1) under M-RoPE; whisper
    adds its absolute position there and cross-attends to ``cache.cross``.

    With a ``mesh`` (params DTensors, the cache placed by ``cache_specs``,
    ``init_decode_cache(mesh=)`` or ``prefill(mesh=)``) the residual is
    pinned to the batch over the data-parallel axes at each block;
    attention (``_mesh_decode_attend``), the Mamba2 step (on a rank's rows
    and heads) and the MoE run under ``local_map``; the logits come back
    plain and whole."""
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
                    h, new = mamba_decode_step(h, layer_cache, p["attn"], cfg)
                    for k, v in new.items():
                        local_part(layer_cache[k]).copy_(local_part(v))
                if cfg.post_norms:
                    h = L.rmsnorm(h, p["post_norm"], cfg.norm_eps)
                x = residual(x, h, cfg)
                if cache.cross is not None:
                    h = L.rmsnorm(x, p["cross_norm"], cfg.norm_eps)
                    h = L.decode_cross_attention(h, p["cross"], cfg,
                                                 {"k": cache.cross["k"][l],
                                                  "v": cache.cross["v"][l]}, mesh)
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


def _prefill_shard(k, v, spec, s: int, cap: int, mesh) -> tuple:
    """A rank's shards (k, v, kpos) of one layer's prefill cache placed by
    ``spec`` (``cache_specs``' spec of the leaf without its blocks dim):
    ``k`` and ``v`` (B_loc, w, KV, hd) are the last ``w = min(s, cap)``
    keys of the prompt's rows the rank holds, and it keeps those whose ring
    slot ``pos % cap`` lies in its slots. Those keys are at most two runs,
    one in each lap of the ring that the prompt's keys reach, so the writes
    are slices known on the host: no shape depends on a tensor's values and
    nothing waits for the card. Without a mesh (``spec`` P(None, None)) the
    shard is the whole cache."""
    idx, cut = _coord(mesh, spec[1])
    cap_loc = cap // cut
    first = s - k.shape[1]
    kc = k.new_zeros((k.shape[0], cap_loc, *k.shape[2:]))
    vc = torch.zeros_like(kc)
    kp = torch.full((k.shape[0], cap_loc), KPOS_INVALID, dtype=torch.int32, device=k.device)
    for lap in range(first - first % cap, s, cap):
        lo = lap + idx * cap_loc            # the position of this lap's first slot here
        a, z = max(first, lo), min(s, lo + cap_loc)
        if a < z:
            kc[:, a - lo:z - lo] = k[:, a - first:z - first]
            vc[:, a - lo:z - lo] = v[:, a - first:z - first]
            kp[:, a - lo:z - lo] = torch.arange(a, z, dtype=torch.int32, device=k.device)
    return kc, vc, kp


def prefill(params, tokens, cfg: ModelConfig, max_seq: int, *, positions=None,
            enc_frames=None, vis_embeds=None, mesh=None):
    """Process the prompt, build the decode cache. Returns (last_logits, cache).

    For whisper the encoder runs once: ``encode_cross_kv``'s K/V feed the
    prefill's cross-attention and become the cache's. JAX runs the encoder
    twice, in its prefill and again inside its ``encode_cross_kv``; the
    numbers are the same, the encoder work half.

    With a ``mesh`` the forward is ``forward``'s mesh route and the cache
    is placed by ``cache_specs``, as ``init_decode_cache(mesh=)`` places it:
    each rank writes its rows and ring slots of the attention caches, its
    rows and heads of a Mamba2 state, and keeps its rows of the cross K/V.
    The logits come back plain and whole."""
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = _positions(b, s, cfg, dev)
    if mesh is not None:
        struct, specs = cache_layout(cfg, b, max_seq, mesh)
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
                    h, state = mamba_chunked(hpre, p["attn"], cfg, return_state=True, mesh=mesh)
                    new = {**_conv_tail(hpre, p["attn"], cfg), "ssm": state}
                    if mesh is not None:
                        new = {k: constrain(t, mesh, P(*specs.layers[i][k][1:])).to_local()
                               for k, t in new.items()}
                    caches[i].append(new)
                    if cfg.post_norms:
                        h = L.rmsnorm(h, p["post_norm"], cfg.norm_eps)
                    x, _ = apply_ffn(residual(x, h, cfg), p, spec, cfg, mesh)
                    continue
                k, v = L.project_kv(hpre, p["attn"], cfg, positions)
                cap = _attn_cache_cap(spec, max_seq)
                w = min(s, cap)
                kv_spec = P(None, None)
                if mesh is not None:
                    kv_spec = P(*specs.layers[i]["k"][1:])
                    rows = P(kv_spec[0], None, None, None)
                    k, v = (constrain(t, mesh, rows).to_local() for t in (k, v))
                kc, vc, kp = _prefill_shard(k[:, s - w:], v[:, s - w:], kv_spec, s, cap, mesh)
                caches[i].append({"k": kc, "v": vc, "kpos": kp})
                x, _ = _apply_sublayer(x, p, spec, cfg, positions=positions,
                                       cross_kv=_layer_kv(cross, l), mesh=mesh)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = whole(logits_fn(params, x[:, -1:, :], cfg))
        if cross is not None and mesh is not None:
            cross = {k: constrain(t, mesh, specs.cross[k]) for k, t in cross.items()}
    layers = tuple(_stack(c) for c in caches)
    if mesh is not None:
        layers = tuple({k: _placed(t, sp[k], st[k].shape, mesh) for k, t in c.items()}
                       for c, sp, st in zip(layers, specs.layers, struct.layers))
    cache = DecodeCache(lengths=torch.full((b,), s, dtype=torch.int32, device=dev),
                        layers=layers, cross=cross)
    return logits, cache
