"""The port's train step against the JAX package's ``make_train_step``
(mesh None, remat off, peak lr 1e-2, warmup 1: step 0 runs at lr 0) on
weights converted from the JAX init, for six reduced archs: dense, softcap,
MoE, Mamba2, whisper (with encoder frames) and qwen2-vl (patch embeddings,
(B, 3, S) positions). float32, batch 4 x 16, inputs from numpy. Microbatches
and remat are in tests/test_torch_train_microbatches.py, which shares the
helpers here."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_grad_fn, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves

ARCHS = ["qwen3-8b", "gemma2-27b", "olmoe-1b-7b", "mamba2-780m", "whisper-tiny",
         "qwen2-vl-72b"]
B, S, STEPS = 4, 16, 3
HP = dict(peak_lr=1e-2, warmup=1)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batches(cfg, n: int):
    """``n`` batches of numpy inputs, with whisper's frames and qwen2-vl's
    patch embeddings and M-RoPE positions."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
        if cfg.encoder_layers:
            b["enc_frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.vis_tokens:
            b["vis_embeds"] = rng.normal(size=(B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
            b["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                                             (B, 3, S)).copy()
        out.append(b)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return arch, reduced(get_config(arch)), jcfg, jparams


def _port_state(jparams):
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return params, adamw_init(params)


def test_train_step_matches_jax(model):
    """Step-0 loss within 1e-5 relative and each gradient leaf within 1e-4
    relative L2 of JAX's; the ce losses of 3 steps within 5e-3; each leaf's
    parameter update over the 3 steps within 1e-3 relative L2."""
    arch, cfg, jcfg, jparams = model
    batches = _batches(cfg, STEPS)
    jloss = JS.make_loss_fn(jcfg, None, remat=False)
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batches[0]))
    params, opt = _port_state(jparams)
    grads, metrics = make_grad_fn(cfg, remat=False)(params, _torch_batch(batches[0]))
    assert abs(float(metrics["ce"]) - float(jm["ce"])) <= 1e-5 * abs(float(jm["ce"]))
    for g, w in zip(leaves(grads), jax.tree.leaves(jgrads)):
        assert g.shape == w.shape
        assert _rel_l2(g.numpy(), w) <= 1e-4, f"{arch}: a gradient leaf differs"

    jstep = jax.jit(JS.make_train_step(jcfg, None, remat=False, **HP))
    step = make_train_step(cfg, remat=False, **HP)
    jp, js = jparams, jax_adamw_init(jparams)
    before = [p.clone() for p in leaves(params)]
    for b in batches:
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        params, opt, met = step(params, opt, _torch_batch(b))
        np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=5e-3)
    for p0, p, j0, j in zip(before, leaves(params), jax.tree.leaves(jparams),
                            jax.tree.leaves(jp)):
        assert _rel_l2((p - p0).numpy(), np.asarray(j) - np.asarray(j0)) <= 1e-3, \
            f"{arch}: a parameter update differs"
