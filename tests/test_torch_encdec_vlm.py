"""The encoder-decoder (whisper-tiny) and vision-language (qwen2-vl-72b)
families in the port against the JAX package: the new layer pieces at
2e-5, the models' forward, prefill and decode at 5e-3 on the same
``enc_frames`` / ``vis_embeds`` and converted weights, qwen2-vl's engine
tokens, and the engine's refusal of whisper (reduced configs, float32)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve, serve_paged
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine
from repro_torch.serving.paged_model import make_paged_decode_step

FAMILIES = ["whisper-tiny", "qwen2-vl-72b"]


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    return _models(request.param)


def _models(arch, **overrides):
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = reduced(get_config(arch), **overrides)
    return cfg, params_from_jax(jax.tree.map(np.asarray, jparams)), jcfg, jparams


def _t(x):
    return tensor_from_numpy(np.asarray(x))


def _close(out, want, tol):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _extra_inputs(cfg, b, seed):
    """The family's non-token input, as (port kwargs, JAX kwargs): whisper's
    encoder frames (B, enc_seq, D) or qwen2-vl's patch embeddings (B, nv, D)."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_layers:
        name, x = "enc_frames", _randn(rng, b, cfg.encoder_seq, cfg.d_model)
    else:
        name, x = "vis_embeds", _randn(rng, b, cfg.vis_tokens, cfg.d_model)
    return {name: torch.from_numpy(x)}, {name: jnp.asarray(x)}


def _attn_params(jparams, tparams, name="attn"):
    return (jax.tree.map(lambda a: a[0], jparams["blocks"][0][name]),
            T.layer_params(tparams["blocks"][0][name], 0))


# ---------------------------------------------------------------------------
# layer pieces (2e-5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_model", [64, 384])
def test_sinusoidal_positions_match_jax(d_model):
    pos = np.random.default_rng(d_model).integers(0, 200, size=(2, 9))
    out = L.sinusoidal_positions(torch.from_numpy(pos), d_model)
    want = JL.sinusoidal_positions(jnp.asarray(pos), d_model)
    assert out.dtype == torch.float32 and tuple(out.shape) == want.shape
    _close(out, want, 2e-5)


def test_decode_cross_attention_matches_jax():
    cfg, tparams, jcfg, jparams = _models("whisper-tiny")
    jp, tp = _attn_params(jparams, tparams, "cross")
    rng = np.random.default_rng(3)
    x = _randn(rng, 2, 1, cfg.d_model)
    kv = {k: _randn(rng, 2, 13, cfg.n_kv_heads, cfg.head_dim) for k in ("k", "v")}
    out = L.decode_cross_attention(_t(x), tp, cfg, {k: _t(a) for k, a in kv.items()})
    want = JL.decode_cross_attention(jnp.asarray(x), jp, jcfg,
                                     {k: jnp.asarray(a) for k, a in kv.items()})
    _close(out, want, 2e-5)


@pytest.mark.parametrize("sq,skv,threshold", [
    (4, 20, 8192),      # dense
    (4, 20, 8),         # Sq under the threshold, Skv over it: chunked, as JAX
    (20, 4, 8),         # Sq over it: chunked
    (20, 20, 8),
    (3, 3, 8),          # both under it: dense
])
def test_kv_override_takes_jax_route_and_matches(sq, skv, threshold, monkeypatch):
    """Cross-attention through ``kv_override`` (no rope, no k-norm on the
    override, non-causal): the same route as JAX's rule ``max(Sq, Skv) >
    dense_threshold`` picks, and JAX's output within 2e-5."""
    cfg, tparams, jcfg, jparams = _models("qwen3-8b")        # qk-norm and rope to skip
    jp, tp = _attn_params(jparams, tparams)
    rng = np.random.default_rng(sq * 100 + skv)
    x = _randn(rng, 2, sq, cfg.d_model)
    k, v = (_randn(rng, 2, skv, cfg.n_kv_heads, cfg.head_dim) for _ in range(2))
    pos = np.broadcast_to(np.arange(sq)[None], (2, sq))
    taken = []
    for name in ("_dense_attention", "_chunked_attention"):
        fn = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _fn=fn, _name=name, **kw: (
            taken.append(_name), _fn(*a, **kw))[1])
    out = L.multihead_attention(_t(x), tp, cfg, positions=torch.from_numpy(pos.copy()),
                                kv_override=(_t(k), _t(v)), causal=False,
                                dense_threshold=threshold)
    want = JL.multihead_attention(jnp.asarray(x), jp, jcfg, positions=jnp.asarray(pos),
                                  kv_override=(jnp.asarray(k), jnp.asarray(v)), causal=False,
                                  dense_threshold=threshold)
    assert taken == ["_chunked_attention" if max(sq, skv) > threshold else "_dense_attention"]
    _close(out, want, 2e-5)


def test_encode_cross_kv_matches_jax():
    cfg, tparams, jcfg, jparams = _models("whisper-tiny")
    kw, jkw = _extra_inputs(cfg, 2, seed=4)
    got = T.encode_cross_kv(tparams, kw["enc_frames"], cfg)
    want = JT.encode_cross_kv(jparams, jkw["enc_frames"], jcfg)
    for k in ("k", "v"):
        assert tuple(got[k].shape) == (cfg.n_layers, 2, cfg.encoder_seq, cfg.n_kv_heads,
                                       cfg.head_dim)
        _close(got[k], want[k], 2e-5)


def test_encode_cross_kv_refuses_a_mixed_block():
    cfg, tparams, _, _ = _models("whisper-tiny")
    mixed = reduced(get_config("jamba-v0.1-52b"), encoder_layers=2, encoder_seq=16)
    with pytest.raises(NotImplementedError, match="homogeneous"):
        T.encode_cross_kv(tparams, torch.zeros(1, 16, cfg.d_model), mixed)


# ---------------------------------------------------------------------------
# the models (5e-3)
# ---------------------------------------------------------------------------

def test_forward_prefill_decode_match_jax(model):
    """forward, prefill (logits and the K/V, and whisper's cross K/V) and
    three decode steps on the same frames or patch embeddings."""
    cfg, params, jcfg, jparams = model
    b, s, extra = 2, 12, 3
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(b, s + extra))
    ttoks = torch.from_numpy(toks)
    kw, jkw = _extra_inputs(cfg, b, seed=2)
    full, _ = T.forward_logits(params, ttoks, cfg, **kw)
    jfull, _ = JT.forward_logits(jparams, jnp.asarray(toks), jcfg, **jkw)
    _close(full, jfull, 5e-3)
    last, cache = T.prefill(params, ttoks[:, :s], cfg, max_seq=32, **kw)
    jlast, jcache = JT.prefill(jparams, jnp.asarray(toks[:, :s]), jcfg, max_seq=32, **jkw)
    _close(last, jlast, 5e-3)
    assert (cache.cross is None) == (jcache.cross is None) == (not cfg.encoder_layers)
    if cache.cross is not None:
        for k in ("k", "v"):
            _close(cache.cross[k], jcache.cross[k], 5e-3)
    for t in range(s, s + extra):
        lg, cache = T.decode_step(params, ttoks[:, t:t + 1], cache, cfg)
        jlg, jcache = JT.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache, jcfg)
        _close(lg, jlg, 5e-3)
    for lc, jlc in zip(cache.layers, jcache.layers):
        for k in lc:
            _close(lc[k], jlc[k], 5e-3)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_matches_forward(arch):
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    b, s, extra = 2, 24, 3
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, size=(b, s + extra)))
    kw, _ = _extra_inputs(cfg, b, seed=5)
    full, _ = T.forward_logits(params, toks, cfg, **kw)
    last, cache = T.prefill(params, toks[:, :s], cfg, max_seq=64, **kw)
    _close(last, full[:, s - 1:s], 5e-3)
    for t in range(s, s + extra):
        lg, cache = T.decode_step(params, toks[:, t:t + 1], cache, cfg)
        _close(lg, full[:, t:t + 1], 5e-3)


@pytest.fixture
def flash_route(monkeypatch):
    """The card's attention route, on the CPU: ``multihead_attention`` goes
    through ``ops.flash_attention`` at every length (its plain version here)."""
    def via_flash(q, k, v, *, causal, window, softcap, q_offset=0, **_):
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)

    monkeypatch.setattr(L, "_dense_attention", via_flash)
    monkeypatch.setattr(L, "_chunked_attention", via_flash)


def test_prefill_through_flash_route_matches_jax(model, flash_route):
    """Prefill as it runs on the card: whisper's encoder (non-causal) and
    cross-attention (Sq != Skv, non-causal) and qwen2-vl's M-RoPE layers all
    through the flash entry point."""
    cfg, params, jcfg, jparams = model
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 20))
    kw, jkw = _extra_inputs(cfg, 2, seed=7)
    last, cache = T.prefill(params, torch.from_numpy(toks), cfg, max_seq=32, **kw)
    jlast, jcache = JT.prefill(jparams, jnp.asarray(toks), jcfg, max_seq=32, **jkw)
    _close(last, jlast, 5e-3)
    for lc, jlc in zip(cache.layers, jcache.layers):
        _close(lc["k"], jlc["k"], 5e-3)
        _close(lc["v"], jlc["v"], 5e-3)


def test_prefill_runs_the_encoder_once(monkeypatch):
    """The port's prefill feeds one encoder run to both the cross-attention
    and the cache's cross K/V (JAX runs it twice); the numbers are JAX's
    (``test_forward_prefill_decode_match_jax``)."""
    cfg = reduced(get_config("whisper-tiny"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    runs = []
    encoder = T._encoder_forward
    monkeypatch.setattr(T, "_encoder_forward", lambda *a: (runs.append(1), encoder(*a))[1])
    kw, _ = _extra_inputs(cfg, 1, seed=8)
    T.prefill(params, torch.tensor([[1, 2, 3]]), cfg, max_seq=8, **kw)
    assert len(runs) == 1


def test_whisper_needs_its_frames():
    cfg = reduced(get_config("whisper-tiny"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="enc_frames"):
        T.prefill(params, torch.tensor([[1, 2, 3]]), cfg, max_seq=8)


@pytest.mark.parametrize("arch", FAMILIES)
def test_embeddings_round_as_jax_in_bf16(arch):
    """bf16: whisper's sinusoidal positions are cast to bf16 and then added,
    qwen2-vl's patch embeddings are cast to bf16 before they replace the
    first token embeddings, as in JAX; decode's absolute position too."""
    cfg, params, jcfg, jparams = _models(arch, dtype="bfloat16")
    toks = np.random.default_rng(9).integers(0, cfg.vocab, size=(2, 12))
    kw, jkw = _extra_inputs(cfg, 2, seed=10)
    vis = {"vis_embeds": kw["vis_embeds"]} if "vis_embeds" in kw else {}
    jvis = {"vis_embeds": jkw["vis_embeds"]} if "vis_embeds" in jkw else {}
    out = T.embed_tokens(params, torch.from_numpy(toks), cfg, **vis)
    want = JT.embed_tokens(jparams, jnp.asarray(toks), jcfg, **jvis)
    assert out.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    # bitwise: adding in f32 and rounding once would move many values by a bf16 step
    _close(out, want.astype(jnp.float32), 0.0)
    if vis:
        nv = cfg.vis_tokens
        assert torch.equal(out[:, :nv], vis["vis_embeds"].to(torch.bfloat16))


def test_transformer_module_holds_the_encoder_and_cross_trees():
    for arch in FAMILIES:
        cfg = reduced(get_config(arch))
        model = T.Transformer.random(cfg, torch.Generator().manual_seed(0))
        sd = model.state_dict()
        toks = torch.tensor([[1, 2, 3, 4]])
        kw, _ = _extra_inputs(cfg, 1, seed=11)
        if cfg.encoder_layers:
            assert {"encoder.blocks.attn.wq", "encoder.final_norm", "blocks.0.cross.wq",
                    "blocks.0.cross_norm"} <= set(sd)
            assert sd["encoder.blocks.attn.wq"].shape[0] == cfg.encoder_layers
        else:
            kw["vis_embeds"] = kw["vis_embeds"][:, :2]
        want, _ = T.forward_logits(model.tree(), toks, cfg, **kw)
        _close(model(toks, **kw), want.numpy(), 0.0)


# ---------------------------------------------------------------------------
# serving: qwen2-vl on the engine, whisper refused
# ---------------------------------------------------------------------------

PROMPTS = [[5, 7, 11, 13, 17], [2, 3], [21, 22, 23, 24, 25, 26, 27, 28, 29]]


def _dense_greedy(params, cfg, prompt, n):
    last, cache = T.prefill(params, torch.tensor([prompt]), cfg, max_seq=128)
    out = []
    t = last[:, -1, :].argmax(-1)[:, None]
    for _ in range(n):
        out.append(int(t[0, 0]))
        lg, cache = T.decode_step(params, t, cache, cfg)
        t = lg[:, -1, :].argmax(-1)[:, None]
    return out


def test_qwen2_vl_engine_tokens_match_jax_engine():
    """Text prompts under the default M-RoPE positions ((B, 3, 1) in the
    paged step): the JAX engine's greedy tokens, and dense decode's."""
    cfg, params, jcfg, jparams = _models("qwen2-vl-72b")
    kw = dict(max_batch=3, page_size=8, num_sets=16, set_size=4)
    eng, jeng = ServeEngine(cfg, params, device="cpu", **kw), JaxServeEngine(jcfg, jparams, **kw)
    rids = [eng.submit(p, max_new=10) for p in PROMPTS]
    jrids = [jeng.submit(p, max_new=10) for p in PROMPTS]
    eng.run(200)
    jeng.run(200)
    for rid, jrid, p in zip(rids, jrids, PROMPTS):
        assert eng.result(rid).state == "done"
        assert eng.result(rid).out == jeng.result(jrid).out
        assert eng.result(rid).out == _dense_greedy(params, cfg, p, 10)
    eng.close()
    jeng.close()


def test_qwen2_vl_engine_exact_under_pool_pressure():
    cfg = reduced(get_config("qwen2-vl-72b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3,
                      device="cpu")
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 250, int(rng.integers(3, 20)))]
               for _ in range(6)]
    rids = [eng.submit(p, max_new=24) for p in prompts]
    eng.run(800)
    st = eng.stats()
    assert st["preemptions"] > 0 and st["offloads"] > 0 and st["fetches"] > 0
    for rid, p in zip(rids, prompts):
        assert eng.result(rid).out == _dense_greedy(params, cfg, p, 24), f"rid{rid}"
    eng.close()


def test_paged_step_positions_are_mrope_streams(monkeypatch):
    """Under M-RoPE the paged step rotates by (B, 3, 1) positions, all three
    streams at the row's length, as JAX's step."""
    cfg = reduced(get_config("qwen2-vl-72b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    seen = []
    rope = L.apply_rope
    monkeypatch.setattr(L, "apply_rope", lambda x, pos, *a: (seen.append(pos), rope(x, pos, *a))[1])
    pools = tuple({k: torch.zeros(cfg.n_blocks, 7, 8, cfg.n_kv_heads, cfg.head_dim)
                   for k in ("k", "v")} for _ in cfg.block)
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    make_paged_decode_step(cfg, page_size=8)(
        params, pools, torch.tensor([[3], [4]]), lengths,
        torch.arange(6, dtype=torch.int32).reshape(2, 3), torch.tensor([True, True]))
    assert seen and all(tuple(p.shape) == (2, 3, 1) for p in seen)
    assert torch.equal(seen[0][:, :, 0], lengths[:, None].expand(2, 3))


def test_engine_refuses_whisper_before_any_state():
    cfg = reduced(get_config("whisper-tiny"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    made = []
    init = ServeEngine.__init__

    def counted(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        counted(ServeEngine.__new__(ServeEngine), cfg, params, device="cpu")
    assert made and not vars(made[0])           # raised before any attribute was set
    with pytest.raises(NotImplementedError, match="JAX engine cannot serve it"):
        make_paged_decode_step(cfg, page_size=8)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        serve.main(["--arch", "whisper-tiny", "--preset", "smoke", "--device", "cpu"])


def test_serve_cli_qwen2_vl_smoke_preset(capsys):
    eng = serve.main(["--arch", "qwen2-vl-72b", "--preset", "smoke", "--device", "cpu",
                      "--requests", "4", "--max-new", "6"])
    assert all(r.state == "done" for r in eng._reqs.values())
    assert "4/4 done" in capsys.readouterr().out


def test_serve_paged_twin_preempts_and_finishes(capsys):
    """The twin of examples/serve_paged.py: 8 requests overflow the
    12-page pool, some are preempted, all finish."""
    eng = serve_paged.main(["--device", "cpu"])
    assert all(r.state == "done" and len(r.out) == 16 for r in eng._reqs.values())
    assert eng.stats()["preemptions"] > 0
    assert "pool stats:" in capsys.readouterr().out
