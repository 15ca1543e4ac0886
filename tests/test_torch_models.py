"""The port's layers and dense transformer against the JAX package, on the
same numpy inputs and converted weights (reduced configs, float32)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import LayerSpec
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ["tinyllama-1.1b", "qwen3-8b"]
DENSE_ARCHS = ["tinyllama-1.1b", "qwen3-8b", "gemma2-27b", "h2o-danube-3-4b"]


def _models(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, reduced(get_config(arch)), tparams


def _t(x):
    return tensor_from_numpy(np.asarray(x))


def _close(out, want, tol):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# layers, one function at a time (2e-5)
# ---------------------------------------------------------------------------

def _case_rmsnorm(rng):
    x, s = _randn(rng, 2, 5, 32), _randn(rng, 32)
    return (L.rmsnorm(_t(x), _t(s), 1e-5),
            JL.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5))


def _case_rope(rng):
    x = _randn(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 100, size=(2, 7))
    return (L.apply_rope(_t(x), torch.from_numpy(pos), 1e6),
            JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def _case_mrope(rng):
    x = _randn(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 100, size=(2, 3, 7))
    return (L.apply_rope(_t(x), torch.from_numpy(pos), 1e4, (4, 2, 2)),
            JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, (4, 2, 2)))


def _attn_inputs(rng, sq=12, skv=12):
    return _randn(rng, 2, sq, 4, 16), _randn(rng, 2, skv, 2, 16), _randn(rng, 2, skv, 2, 16)


def _case_dense(rng):
    q, k, v = _attn_inputs(rng)
    kw = dict(causal=True, window=5, softcap=20.0)
    return (L._dense_attention(_t(q), _t(k), _t(v), **kw),
            JL._dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def _case_dense_q_offset(rng):
    q, k, v = _attn_inputs(rng, sq=4, skv=12)
    kw = dict(causal=True, window=0, softcap=0.0, q_offset=8)
    return (L._dense_attention(_t(q), _t(k), _t(v), **kw),
            JL._dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def _case_chunked(rng):
    q, k, v = _attn_inputs(rng, sq=20, skv=20)
    kw = dict(causal=True, window=7, softcap=0.0, kv_chunk=8)   # 3 chunks, padded
    return (L._chunked_attention(_t(q), _t(k), _t(v), **kw),
            JL._chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def _case_decode(rng):
    q, k, v = _attn_inputs(rng, sq=1, skv=10)
    lengths = np.array([4, 10], np.int32)
    kpos = rng.permutation(10)[None, :].repeat(2, 0).astype(np.int32)
    kw = dict(softcap=30.0)
    return (L.decode_attention(_t(q), _t(k), _t(v), lengths=torch.from_numpy(lengths),
                               kpos=torch.from_numpy(kpos), **kw),
            JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                lengths=jnp.asarray(lengths), kpos=jnp.asarray(kpos), **kw))


def _case_mlp(rng, act="silu"):
    x = _randn(rng, 2, 3, 16)
    p = {"w_gate": _randn(rng, 16, 24), "w_up": _randn(rng, 16, 24),
         "w_down": _randn(rng, 24, 16)}
    return (L.mlp(_t(x), {k: _t(v) for k, v in p.items()}, act),
            JL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, act))


LAYER_CASES = {
    "rmsnorm": _case_rmsnorm, "rope": _case_rope, "mrope": _case_mrope,
    "dense_attention": _case_dense, "dense_attention_q_offset": _case_dense_q_offset,
    "chunked_attention": _case_chunked, "decode_attention": _case_decode,
    "mlp_silu": _case_mlp, "mlp_gelu": lambda rng: _case_mlp(rng, "gelu"),
}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_matches_jax(name):
    out, want = LAYER_CASES[name](np.random.default_rng(sorted(LAYER_CASES).index(name)))
    assert tuple(out.shape) == want.shape
    _close(out, want, 2e-5)


def test_multihead_attention_dense_and_chunked_paths_match_jax():
    jcfg, jparams, cfg, tparams = _models("qwen3-8b")
    x = np.random.default_rng(5).normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20)[None], (2, 20))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["attn"])
    tp = T.layer_params(tparams["blocks"][0]["attn"], 0)
    for thr in (8192, 8):                          # dense, then chunked
        out = L.multihead_attention(_t(x), tp, cfg, positions=torch.from_numpy(pos.copy()),
                                    dense_threshold=thr)
        want = JL.multihead_attention(jnp.asarray(x), jp, jcfg, positions=jnp.asarray(pos),
                                      dense_threshold=thr)
        _close(out, want, 2e-5)


# ---------------------------------------------------------------------------
# the model (5e-3, as tests/test_models.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def flash_route(monkeypatch):
    """The card's attention route, on the CPU: ``multihead_attention`` goes
    through ``ops.flash_attention`` at every length (its plain version here,
    the Hopper kernel on the card) instead of the dense/chunked rule."""
    def via_flash(q, k, v, *, causal, window, softcap, q_offset=0, **_):
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)

    monkeypatch.setattr(L, "_dense_attention", via_flash)
    monkeypatch.setattr(L, "_chunked_attention", via_flash)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_through_flash_route_matches_jax(arch, flash_route):
    """Prefill as it runs on the card (flash attention in every layer): the
    last-position logits and the K/V cache equal JAX's prefill."""
    jcfg, jparams, cfg, tparams = _models(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 20))
    last, cache = T.prefill(tparams, torch.from_numpy(toks), cfg, max_seq=32)
    jlast, jcache = JT.prefill(jparams, jnp.asarray(toks), jcfg, max_seq=32)
    _close(last, jlast, 5e-3)
    for lc, jlc in zip(cache.layers, jcache.layers):
        _close(lc["k"], jlc["k"], 5e-3)
        _close(lc["v"], jlc["v"], 5e-3)

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, jparams, cfg, tparams = _models(arch)
    b, s, extra = 2, 12, 3
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(b, s + extra))
    ttoks = torch.from_numpy(toks)
    full, _ = T.forward_logits(tparams, ttoks, cfg)
    jfull, _ = JT.forward_logits(jparams, jnp.asarray(toks), jcfg)
    _close(full, jfull, 5e-3)
    last, cache = T.prefill(tparams, ttoks[:, :s], cfg, max_seq=32)
    jlast, jcache = JT.prefill(jparams, jnp.asarray(toks[:, :s]), jcfg, max_seq=32)
    _close(last, jlast, 5e-3)
    for t in range(s, s + extra):
        lg, cache = T.decode_step(tparams, ttoks[:, t:t + 1], cache, cfg)
        jlg, jcache = JT.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache, jcfg)
        _close(lg, jlg, 5e-3)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_decode_matches_forward(arch):
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    b, s, extra = 2, 24, 3
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, size=(b, s + extra)))
    full, _ = T.forward_logits(params, toks, cfg)
    last, cache = T.prefill(params, toks[:, :s], cfg, max_seq=64)
    _close(last, full[:, s - 1:s], 5e-3)
    for t in range(s, s + extra):
        lg, cache = T.decode_step(params, toks[:, t:t + 1], cache, cfg)
        _close(lg, full[:, t:t + 1], 5e-3)


def test_sliding_window_ring_buffer_wraps():
    """danube-style SWA: decode far past the window; ring must stay correct."""
    cfg = dataclasses.replace(reduced(get_config("h2o-danube-3-4b")),
                              block=(LayerSpec(kind="attn", ffn="mlp", window=8),),
                              n_layers=2)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    b, s, extra = 1, 12, 10
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, size=(b, s + extra)))
    full, _ = T.forward_logits(params, toks, cfg)
    last, cache = T.prefill(params, toks[:, :s], cfg, max_seq=64)
    _close(last, full[:, s - 1:s], 5e-3)
    for t in range(s, s + extra):
        lg, cache = T.decode_step(params, toks[:, t:t + 1], cache, cfg)
        _close(lg, full[:, t:t + 1], 5e-3)


# ---------------------------------------------------------------------------
# parameters and families
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_init_has_jax_layout_dtypes_and_scales(arch, dtype):
    jcfg = jax_reduced(jax_get_config(arch), dtype=dtype)
    jleaves = dict(_leaves(jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))))
    cfg = reduced(get_config(arch), dtype=dtype)
    tleaves = dict(_leaves(T.init_params(cfg, torch.Generator().manual_seed(0))))
    assert tleaves.keys() == jleaves.keys()
    for k, want in jleaves.items():
        got = tleaves[k]
        assert tuple(got.shape) == want.shape, k
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), k
        if k.endswith(("wq", "embed", "w_up")):           # N(0,1) * d**-0.5
            assert abs(got.float().std().item() * cfg.d_model ** 0.5 - 1) < 0.1, k
        if "norm" in k:
            assert torch.all(got == 0), k


def test_transformer_module_holds_the_tree():
    cfg = reduced(get_config("qwen3-8b"))
    model = T.Transformer.random(cfg, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert "blocks.0.attn.wq" in sd and "embed" in sd and "lm_head" in sd
    assert sd["blocks.0.attn.q_norm"].dtype == torch.float32
    toks = torch.tensor([[1, 2, 3]])
    want, _ = T.forward_logits(model.tree(), toks, cfg)
    _close(model.to("cpu")(toks), want.numpy(), 0.0)


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_later_slice_families_raise(arch):
    """whisper-tiny and qwen2-vl-72b, once the families that raised, now
    initialise with JAX's tree (whisper's ``encoder`` and ``cross`` leaves
    included), shapes and dtypes, and converted weights give JAX's logits."""
    jcfg = jax_reduced(jax_get_config(arch))
    jleaves = dict(_leaves(jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))))
    tleaves = dict(_leaves(T.init_params(reduced(get_config(arch)),
                                         torch.Generator().manual_seed(0))))
    assert tleaves.keys() == jleaves.keys()
    for k, want in jleaves.items():
        assert tuple(tleaves[k].shape) == want.shape, k
        assert str(tleaves[k].dtype).removeprefix("torch.") == str(want.dtype), k
    jcfg, jparams, cfg, tparams = _models(arch)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, size=(2, 10))
    extra = ("enc_frames", (2, cfg.encoder_seq, cfg.d_model)) if cfg.encoder_layers else (
        "vis_embeds", (2, cfg.vis_tokens, cfg.d_model))
    x = rng.normal(size=extra[1]).astype(np.float32)
    out, _ = T.forward_logits(tparams, torch.from_numpy(toks), cfg,
                              **{extra[0]: torch.from_numpy(x)})
    want, _ = JT.forward_logits(jparams, jnp.asarray(toks), jcfg, **{extra[0]: jnp.asarray(x)})
    _close(out, want, 5e-3)
