"""Model assembly for the dense-attention families (tinyllama, qwen3, gemma2,
h2o-danube), mirroring ``repro/models/transformer.py``.

* The layer stack is ``n_blocks`` repetitions of the config's ``block``
  pattern. Parameters of pattern position ``i`` are stacked over blocks with
  leading dim ``n_blocks``, the same tree as the JAX package, so converted
  JAX weights drop in; where JAX runs the stack as one ``lax.scan``, the port
  loops over blocks in Python.
* Train/prefill forward, single-token decode with KV caches (ring buffers
  for sliding-window layers).
* Decode caches are updated in place (JAX returns new arrays): the cache
  passed to ``decode_step`` is the one returned, with its lengths advanced.

Mamba, MoE, the whisper encoder and the qwen2-vl vision inputs are not in
this slice of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from . import layers as L

KPOS_INVALID = (2 ** 31 - 1) // 2   # empty ring slot: always masked


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families whose port is a later slice (see ROADMAP.md)."""
    later = "is not ported yet: it comes with the 'other model families' slice"
    if cfg.encoder_layers:
        raise NotImplementedError(f"{cfg.name}: the whisper encoder/cross-attention {later}")
    if cfg.vis_tokens or cfg.mrope_sections:
        raise NotImplementedError(f"{cfg.name}: the qwen2-vl vision/M-RoPE path {later}")
    for spec in cfg.block:
        if spec.kind != "attn":
            raise NotImplementedError(f"{cfg.name}: mamba sublayers {later}")
        if spec.ffn == "moe":
            raise NotImplementedError(f"{cfg.name}: MoE feed-forward {later}")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _init_sublayer(generator, spec: LayerSpec, cfg: ModelConfig, device) -> dict:
    p: dict = {"norm": L.init_rmsnorm(cfg.d_model, device)["scale"],
               "attn": L.init_attention(generator, cfg, device)}
    if cfg.post_norms:
        p["post_norm"] = L.init_rmsnorm(cfg.d_model, device)["scale"]
    if spec.ffn == "mlp":
        p["ffn_norm"] = L.init_rmsnorm(cfg.d_model, device)["scale"]
        p["mlp"] = L.init_mlp(generator, cfg, device=device)
        if cfg.post_norms:
            p["ffn_post_norm"] = L.init_rmsnorm(cfg.d_model, device)["scale"]
    return p


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(tree, l: int):
    """Block ``l``'s slice of a stacked parameter (or cache) tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, l) for k, v in tree.items()}
    return tree[l]


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights on ``device`` with the JAX tree layout, dtypes and
    scales (N(0,1) * d**-0.5 matrices in the config dtype, zero f32 norm
    scales). The numbers differ from ``jax.random``'s: parity with the JAX
    init is statistical only."""
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    params: dict = {
        "embed": L.init_normal((cfg.vocab, cfg.d_model), generator, device,
                               cfg.d_model ** -0.5, dt),
        "final_norm": L.init_rmsnorm(cfg.d_model, device)["scale"],
    }
    params["blocks"] = tuple(
        _stack([_init_sublayer(generator, spec, cfg, device) for _ in range(cfg.n_blocks)])
        for spec in cfg.block)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_normal((cfg.d_model, cfg.vocab), generator, device,
                                          cfg.d_model ** -0.5, dt)
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
        check_supported(cfg)
        super().__init__(params)
        self.cfg = cfg

    @classmethod
    def random(cls, cfg: ModelConfig, generator: torch.Generator, device=None):
        return cls(cfg, init_params(cfg, generator, device))

    def forward(self, tokens):
        return forward_logits(self.tree(), tokens, self.cfg)[0]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens]          # (B, S, D)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


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

def apply_ffn(x, p, spec: LayerSpec, cfg: ModelConfig):
    if spec.ffn == "mlp":
        h = L.rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
        h = L.mlp(h, p["mlp"], cfg.act)
        if cfg.post_norms:
            h = L.rmsnorm(h, p["ffn_post_norm"], cfg.norm_eps)
        x = x + h
    return x


def _apply_sublayer(x, p, spec: LayerSpec, cfg: ModelConfig, *, positions):
    """One sublayer (attn + ffn) in train/prefill form."""
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    h = L.multihead_attention(h, p["attn"], cfg, positions=positions,
                              window=spec.window, causal=True)
    if cfg.post_norms:
        h = L.rmsnorm(h, p["post_norm"], cfg.norm_eps)
    return apply_ffn(x + h, p, spec, cfg)


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device)[None, :].expand(b, s)


def forward(params, tokens, cfg: ModelConfig, *, positions=None):
    """Trunk forward. Returns (final_hidden (B,S,D), aux losses dict)."""
    check_supported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = _positions(b, s, tokens.device)
    x = embed_tokens(params, tokens, cfg)
    for l in range(cfg.n_blocks):
        for i, spec in enumerate(cfg.block):
            x = _apply_sublayer(x, layer_params(params["blocks"][i], l), spec, cfg,
                                positions=positions)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), {"lb": zero, "z": zero}


def forward_logits(params, tokens, cfg: ModelConfig, **kw):
    """Materialized logits — tests and small configs."""
    x, aux = forward(params, tokens, cfg, **kw)
    return logits_fn(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    lengths: torch.Tensor    # (B,) tokens already in cache
    layers: tuple            # per pattern position: {"k","v","kpos"} stacked over blocks


def _attn_cache_cap(spec: LayerSpec, max_seq: int) -> int:
    return min(spec.window, max_seq) if spec.window else max_seq


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> DecodeCache:
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    nb = cfg.n_blocks
    layer_caches = []
    for spec in cfg.block:
        cap = _attn_cache_cap(spec, max_seq)
        shape = (nb, batch, cap, cfg.n_kv_heads, cfg.head_dim)
        layer_caches.append({
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "kpos": torch.full((nb, batch, cap), KPOS_INVALID, dtype=torch.int32,
                               device=device),
        })
    return DecodeCache(lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
                       layers=tuple(layer_caches))


# ---------------------------------------------------------------------------
# Decode step (one new token per sequence)
# ---------------------------------------------------------------------------

def _decode_attn_sublayer(x, p, cfg: ModelConfig, cache, lengths, positions):
    """x: (B,1,D). cache: {"k","v","kpos"} of THIS layer, written in place."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, 1, h, hd)
    k = (x @ p["wk"]).reshape(b, 1, kvh, hd)
    v = (x @ p["wv"]).reshape(b, 1, kvh, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    cap = cache["k"].shape[1]
    slot = (lengths % cap).long()
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    cache["kpos"][bidx, slot] = lengths
    out = L.decode_attention(q, cache["k"], cache["v"], lengths=lengths + 1,
                             softcap=cfg.attn_softcap, kpos=cache["kpos"])
    return out @ p["wo"]


def decode_step(params, tokens, cache: DecodeCache, cfg: ModelConfig, *, positions=None):
    """tokens: (B, 1) -> (logits (B,1,V), cache). The cache is updated in
    place; the returned one shares its tensors, with lengths + 1."""
    check_supported(cfg)
    lengths = cache.lengths
    if positions is None:
        positions = lengths[:, None]
    x = embed_tokens(params, tokens, cfg)
    for l in range(cfg.n_blocks):
        for i, spec in enumerate(cfg.block):
            p = layer_params(params["blocks"][i], l)
            h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
            h = _decode_attn_sublayer(h, p["attn"], cfg, layer_params(cache.layers[i], l),
                                      lengths, positions)
            if cfg.post_norms:
                h = L.rmsnorm(h, p["post_norm"], cfg.norm_eps)
            x = apply_ffn(x + h, p, spec, cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, x, cfg), DecodeCache(lengths=lengths + 1, layers=cache.layers)


# ---------------------------------------------------------------------------
# Prefill: trunk forward + cache construction
# ---------------------------------------------------------------------------

def prefill(params, tokens, cfg: ModelConfig, max_seq: int, *, positions=None):
    """Process the prompt, build the decode cache. Returns (last_logits, cache)."""
    check_supported(cfg)
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = _positions(b, s, dev)
    x = embed_tokens(params, tokens, cfg)
    caches: list[list[dict]] = [[] for _ in cfg.block]
    for l in range(cfg.n_blocks):
        for i, spec in enumerate(cfg.block):
            p = layer_params(params["blocks"][i], l)
            hpre = L.rmsnorm(x, p["norm"], cfg.norm_eps)
            k, v = L.project_kv(hpre, p["attn"], cfg, positions)
            cap = _attn_cache_cap(spec, max_seq)
            kc = torch.zeros((b, cap, cfg.n_kv_heads, cfg.head_dim), dtype=k.dtype, device=dev)
            vc = torch.zeros_like(kc)
            kp = torch.full((b, cap), KPOS_INVALID, dtype=torch.int32, device=dev)
            w = min(s, cap)
            pos = s - w + torch.arange(w, device=dev)
            sl = pos % cap
            kc[:, sl] = k[:, -w:]
            vc[:, sl] = v[:, -w:]
            kp[:, sl] = pos.to(torch.int32)[None, :]
            caches[i].append({"k": kc, "v": vc, "kpos": kp})
            x = _apply_sublayer(x, p, spec, cfg, positions=positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, x[:, -1:, :], cfg)
    cache = DecodeCache(lengths=torch.full((b,), s, dtype=torch.int32, device=dev),
                        layers=tuple(_stack(c) for c in caches))
    return logits, cache
