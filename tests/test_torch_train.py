"""The port's training pieces against the JAX package: ``lm_loss``, the
``FlashAttention`` Function's gradients, AdamW and the cosine schedule, a
train step with attention through the Function, and ports of the optimizer
and data tests of tests/test_distributed.py, and the prefill and decode step
twins. Reduced sizes, float32, inputs from numpy. The train step against JAX's ``make_train_step`` is in
tests/test_torch_train_steps.py."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.kernels import ref as jax_ref
from repro.launch import steps as jax_steps
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import get_config, reduced
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import Prefetcher, SyntheticLM, to_device
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import make_grad_fn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule
from repro_torch.tree import leaves

F32_TOL = 2e-5


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------

LOSS_CASES = [
    # arch, seq, seq_chunk, masked
    ("tinyllama-1.1b", 16, 1024, False),      # one chunk (c = S)
    ("tinyllama-1.1b", 16, 4, True),          # 4 chunks, masked
    ("tinyllama-1.1b", 12, 5, False),         # 5 does not divide 12: one chunk
    ("gemma2-27b", 16, 8, True),              # logit softcap, tied embeddings
]


@pytest.mark.parametrize("arch,s,chunk,masked", LOSS_CASES)
def test_lm_loss_matches_jax(arch, s, chunk, masked):
    """Value and gradients (hidden, head weight) of the chunked loss within
    2e-5 of JAX's; a mask of all zeros divides by 1."""
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = reduced(get_config(arch))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, size=(2, s)).astype(np.int32)
    mask = (rng.random((2, s)) > 0.3).astype(np.float32) if masked else None
    head = "embed" if cfg.tie_embeddings else "lm_head"

    def jloss(h, w):
        return JT.lm_loss({**jparams, head: w}, jcfg, h, jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask), seq_chunk=chunk)

    want, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(hidden),
                                                                 jparams[head])
    th = torch.from_numpy(hidden).requires_grad_()
    tw = params[head].clone().requires_grad_()
    got = T.lm_loss({**params, head: tw}, cfg, th, torch.from_numpy(labels),
                    None if mask is None else torch.from_numpy(mask), seq_chunk=chunk)
    gh, gw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_np(gh), np.asarray(jgh), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_np(gw), np.asarray(jgw), rtol=F32_TOL, atol=F32_TOL)
    with torch.no_grad():
        zero = T.lm_loss(params, cfg, th, torch.from_numpy(labels), torch.zeros((2, s)))
    assert float(zero) == 0.0


# ---------------------------------------------------------------------------
# the FlashAttention Function
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # b, sq, skv, h, kv, hd, causal, window, softcap, q_offset
    "causal": (2, 24, 24, 4, 2, 16, True, 0, 0.0, 0),
    "window": (2, 24, 24, 4, 2, 16, True, 8, 0.0, 0),
    "softcap": (2, 24, 24, 4, 2, 16, True, 0, 30.0, 0),
    "q_offset": (1, 8, 24, 4, 2, 16, True, 0, 0.0, 16),
    "gqa": (2, 20, 20, 8, 2, 32, True, 6, 20.0, 0),
    "sq_ne_skv": (2, 5, 19, 6, 6, 16, False, 0, 0.0, 0),
    "empty_rows": (1, 10, 20, 4, 2, 16, True, 3, 0.0, 19),
}


def _attn_inputs(case, seed=0):
    b, sq, skv, h, kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd), (b, sq, h, hd))]


def _torch_grads(fn, q, k, v, do):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*ts)
    return [_np(g) for g in torch.autograd.grad(out, ts, torch.from_numpy(do))]


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_flash_function_gradients(name):
    """dq, dk, dv of ``ops.flash_attention`` (the Function: plain forward on
    CPU tensors, ``ref.flash_attention_bwd`` backward, also in chunks of 7
    keys) within 2e-5 of autograd through the port's ``_dense_attention``
    and ``_chunked_attention`` and of ``jax.grad`` of JAX's attention. A row
    with no valid key (output 0) is held to the plain version's autograd
    and JAX's ``ref.flash_attention_ref``, and gets zero gradient."""
    case = ATTN_CASES[name]
    causal, window, softcap, off = case[6:]
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, do = _attn_inputs(case)
    got = _torch_grads(lambda *t: ops.flash_attention(*t, q_offset=off, **kw), q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out = ref.flash_attention_ref(tq, tk, tv, q_offset=off, **kw)
    chunked = [_np(g) for g in ref.flash_attention_bwd(tq, tk, tv, out, tdo, q_offset=off,
                                                       kv_chunk=7, **kw)]
    if name == "empty_rows":
        wants = [_torch_grads(lambda *t: ref.flash_attention_ref(*t, q_offset=off, **kw),
                              q, k, v, do)]
        jfn = lambda *a: jax_ref.flash_attention_ref(*a, q_offset=off, **kw)
        assert np.all(got[0][:, 3:] == 0), "a row with no valid key got a gradient"
    else:
        wants = [_torch_grads(lambda *t: L._dense_attention(*t, q_offset=off, **kw),
                              q, k, v, do)]
        if off == 0:
            wants.append(_torch_grads(lambda *t: L._chunked_attention(*t, kv_chunk=8, **kw),
                                      q, k, v, do))
        jfn = lambda *a: JL._dense_attention(*a, q_offset=off, **kw)
    _, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    wants.append([np.asarray(g) for g in vjp(jnp.asarray(do))])
    for want in wants:
        for g, c, w in zip(got, chunked, want):
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
            np.testing.assert_allclose(c, w, rtol=F32_TOL, atol=F32_TOL)


def test_flash_function_without_grad_is_the_forward():
    """Under no_grad and inference_mode the Function is its forward alone:
    the plain version's output, no graph."""
    q, k, v, _ = (torch.from_numpy(x) for x in _attn_inputs(ATTN_CASES["gqa"]))
    want = ref.flash_attention_ref(q, k, v, window=6, softcap=20.0)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            out = ops.flash_attention(q.requires_grad_(), k, v, window=6, softcap=20.0)
        assert out.grad_fn is None
        torch.testing.assert_close(out, want, rtol=0, atol=0)


def _force_function(monkeypatch):
    """Route the CPU attention of ``multihead_attention`` through the
    Function, as the card's route does."""
    def through_function(q, k, v, *, causal, window, softcap, q_offset=0, kv_chunk=None):
        return ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                   q_offset=q_offset)
    monkeypatch.setattr(L, "_dense_attention", through_function)
    monkeypatch.setattr(L, "_chunked_attention", through_function)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-tiny"])
def test_train_step_through_the_function_equals_cpu_route(arch, monkeypatch):
    """The gradient of a train step (remat, 2 microbatches) with every
    attention call through the Function equals the default CPU route's
    (JAX's dense rule) to 2e-5, leaf by leaf; every leaf's gradient is
    nonzero."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, size=(4, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.encoder_layers:
        batch["enc_frames"] = torch.from_numpy(
            rng.normal(size=(4, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    grad_fn = make_grad_fn(cfg, remat=True, microbatches=2)
    want, wm = grad_fn(params, batch)
    calls = []
    plain_fwd = ops.FlashAttention.forward
    monkeypatch.setattr(ops.FlashAttention, "forward",
                        staticmethod(lambda *a: calls.append(1) or plain_fwd(*a)))
    _force_function(monkeypatch)
    got, gm = grad_fn(params, batch)
    assert calls, "no attention call went through the Function"
    np.testing.assert_allclose(_np(gm["ce"]), _np(wm["ce"]), rtol=F32_TOL)
    for g, w in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL, atol=F32_TOL)
        assert float(g.abs().max()) > 0


def test_prefill_and_decode_step_twins_match_jax():
    """``make_prefill_step`` and ``make_decode_step`` (with ``sample``) give
    JAX's logits within 5e-3 and its greedy tokens."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    jcfg = jax_reduced(jax_get_config("tinyllama-1.1b"))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 9)).astype(np.int32)
    last, cache = make_prefill_step(cfg, 16)(params, {"tokens": torch.from_numpy(toks)})
    jlast, jcache = jax_steps.make_prefill_step(jcfg, 16)(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=5e-3, atol=5e-3)
    nxt = last[:, -1].argmax(-1).to(torch.int32)[:, None]
    lg, cache = make_decode_step(cfg)(params, cache, {"tokens": nxt})
    jlg, jcache = jax_steps.make_decode_step(jcfg)(jparams, jcache, {"tokens": jnp.asarray(nxt.numpy())})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=5e-3, atol=5e-3)
    tok, _ = make_decode_step(cfg, sample=True)(params, cache, {"tokens": nxt})
    jtok, _ = jax_steps.make_decode_step(jcfg, sample=True)(jparams, jcache,
                                                     {"tokens": jnp.asarray(nxt.numpy())})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

def _opt_tree(rng, dtype):
    """Stacked like the model: a (n_blocks, d) norm leaf, matrices, a 1-d norm."""
    return {"blocks": ({"norm": rng.normal(size=(3, 8)).astype(np.float32),
                        "attn": {"wq": rng.normal(size=(3, 8, 4)).astype(dtype)}},),
            "embed": rng.normal(size=(16, 8)).astype(dtype),
            "final_norm": rng.normal(size=(8,)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Three updates from the same numpy grads: params, m, v and the master
    copy within 1e-6 of JAX's (the bf16 params equal JAX's bf16 params),
    lr and grad norm too; the stacked (n_blocks, d) norm scales decay, as
    JAX decays every leaf with ndim >= 2."""
    import ml_dtypes
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(3)
    tree = _opt_tree(rng, np_dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jax_adamw_init(jp)
    tp = params_from_jax(tree)
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js))
    assert (ts.master is None) == (dtype == "float32")
    assert leaves(adamw_init(tp)) and len(leaves(adamw_init(tp))) == len(leaves(ts))
    for _ in range(3):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3).astype(x.dtype), tree)
        jlr = jax_cosine_schedule(js.step, peak_lr=1e-2, warmup=1, total=10)
        lr = cosine_schedule(ts.step, peak_lr=1e-2, warmup=1, total=10)
        jp, js, jm = jax_adamw_update(jax.tree.map(jnp.asarray, g), js, jp, lr=jlr)
        tp, ts, tm = adamw_update(params_from_jax(g), ts, tp, lr=lr)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for got, want in zip(leaves((tp, ts)), jax.tree.leaves((jp, js))):
        want = np.asarray(want)
        if want.dtype == np.int32:
            assert int(got) == int(want)
        elif want.dtype == np_dtype and dtype == "bfloat16":
            np.testing.assert_array_equal(_np(got), want.astype(np.float32))
        else:
            np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    # decay alone: zero grads shrink the stacked norm scales, not the 1-d ones
    p = {"stacked": torch.ones((3, 8)), "flat": torch.ones((8,))}
    p, _, _ = adamw_update({k: torch.zeros_like(v) for k, v in p.items()},
                           adamw_init(p), p, lr=0.1)
    assert float(p["stacked"].max()) < 1.0 and float(p["flat"].min()) == 1.0


def test_adamw_converges_on_quadratic():
    """Port of tests/test_distributed.py::test_adamw_converges_on_quadratic."""
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = adamw_init(params, master_fp32=False)
    for _ in range(300):
        params, state, _ = adamw_update({"w": 2 * params["w"]}, state, params, lr=0.05,
                                        weight_decay=0.0)
    assert float(params["w"].square().sum()) < 1e-3


def test_adamw_clip_and_metrics():
    params = {"w": torch.ones((4,))}
    state = adamw_init(params, master_fp32=False)
    _, _, m = adamw_update({"w": torch.full((4,), 100.0)}, state, params, lr=0.1,
                           clip_norm=1.0)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_master_fp32_roundtrip():
    params = {"w": torch.ones((8,), dtype=torch.bfloat16)}
    state = adamw_init(params, master_fp32=True)
    assert state.master is not None and isinstance(state, AdamWState)
    _, s2, _ = adamw_update({"w": torch.full((8,), 1e-3, dtype=torch.bfloat16)}, state,
                            params, lr=1e-4)
    # master accumulates below bf16 resolution
    assert float((s2.master["w"] - 1.0).abs().max()) > 0
    assert s2.step.dtype == torch.int32 and s2.step.dim() == 0


def test_cosine_schedule_shape():
    s = [float(cosine_schedule(torch.tensor(i), peak_lr=1.0, warmup=10, total=100))
         for i in range(100)]
    assert s[0] == 0.0 and abs(s[10] - 1.0) < 0.11
    assert s[-1] < 0.2 and all(x >= 0 for x in s)
    want = [float(jax_cosine_schedule(jnp.asarray(i), peak_lr=1.0, warmup=10, total=100))
            for i in range(100)]
    np.testing.assert_allclose(s, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_data_deterministic():
    """Port of test_synthetic_data_deterministic, and the same tokens as
    the JAX package's stream."""
    from repro.data import SyntheticLM as JaxSyntheticLM
    d1 = SyntheticLM(1000, 64, 4, seed=7).batch(3)
    d2 = SyntheticLM(1000, 64, 4, seed=7).batch(3)
    np.testing.assert_array_equal(d1["tokens"], d2["tokens"])
    assert (d1["labels"][:, :-1] == d1["tokens"][:, 1:]).all()
    j = JaxSyntheticLM(1000, 64, 4, seed=7).batch(3)
    for k in j:
        np.testing.assert_array_equal(d1[k], j[k])


def test_prefetcher_orders_and_closes():
    it = Prefetcher(iter(range(10)), depth=3)
    assert list(it) == list(range(10))
    it.close()


def test_to_device_keeps_dtypes():
    batch = SyntheticLM(50, 8, 2).batch(0)
    out = to_device(batch, "cpu")
    for k, v in batch.items():
        assert out[k].dtype == torch.from_numpy(v).dtype and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), v)
