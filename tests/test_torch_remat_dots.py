"""``forward(remat="dots")``: JAX's ``dots_saveable`` as a selective
checkpoint. On reduced fp32 models of four families (dense, MoE, Mamba2,
encoder-decoder), weights converted from the JAX init and inputs from numpy,
its gradients equal ``remat=True``'s within 1e-5 relative L2 and JAX's
``remat="dots"`` gradients within the train tests' 1e-4; counted with
``launch/cost.py``'s mode, its backward recomputes no matrix product, where
``remat=True`` recomputes each block's forward products once. And the
gradient function takes ``remat="dots"`` at the train steps' batch shape."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch.cost import CostMode
from repro_torch.launch.steps import make_grad_fn, make_loss_fn
from repro_torch.tree import leaves, unflatten

ARCHS = ["tinyllama-1.1b", "olmoe-1b-7b", "mamba2-780m", "whisper-tiny"]
B, S = 2, 16


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if cfg.encoder_layers:
        b["enc_frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return arch, reduced(get_config(arch)), jcfg, jparams


def _grads(cfg, params, batch, remat):
    grads, metrics = make_grad_fn(cfg, remat=remat)(params, batch)
    return [g.numpy() for g in leaves(grads)], float(metrics["ce"])


def test_dots_gradients_match_remat_and_jax(model):
    arch, cfg, jcfg, jparams = model
    batch = _batch(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    dots, ce_dots = _grads(cfg, params, tb, "dots")
    full, ce_full = _grads(cfg, params, tb, True)
    assert ce_dots == pytest.approx(ce_full, rel=1e-6)
    for i, (a, b) in enumerate(zip(dots, full)):
        assert _rel_l2(a, b) <= 1e-5, (arch, i)
    jloss = JS.make_loss_fn(jcfg, None, remat="dots")
    (_, jm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    assert ce_dots == pytest.approx(float(jm["ce"]), rel=1e-5)
    for i, (a, b) in enumerate(zip(dots, jax.tree.leaves(jgrads))):
        assert _rel_l2(a, np.asarray(b)) <= 1e-4, (arch, i)


def test_grad_fn_takes_remat_dots():
    """``make_grad_fn`` takes ``remat="dots"`` (which it once refused) and
    gives ``remat=True``'s gradient within 1e-5 relative L2: reduced
    tinyllama, weights from the JAX init, a batch of 4 x 16 tokens without a
    mask (the shape of ``tests/test_torch_train_steps.py``'s batches)."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    jparams = JT.init_params(jax.random.PRNGKey(0), jax_reduced(jax_get_config("tinyllama-1.1b")))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(4, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    dots, _ = _grads(cfg, params, batch, "dots")
    full, _ = _grads(cfg, params, batch, True)
    for a, b in zip(dots, full):
        assert _rel_l2(a, b) <= 1e-5


def _matmul_flops(cfg, params, batch, remat) -> tuple[int, int]:
    """(forward, backward) matrix-unit FLOPs of one loss and gradient."""
    ps = [p.detach().requires_grad_() for p in leaves(params)]
    fwd, bwd = CostMode(), CostMode()
    with fwd:
        total, _ = make_loss_fn(cfg, remat=remat)(unflatten(params, ps), batch)
    with bwd:
        torch.autograd.grad(total, ps, allow_unused=True)
    return fwd.flops, bwd.flops


def test_dots_recomputes_no_matmul():
    """The backward's matrix FLOPs: ``"dots"`` equals no remat (nothing
    recomputed), ``True`` adds each block's forward products once: the
    forward's FLOPs less the loss head (which ``lm_loss`` checkpoints under
    every setting) and less each block's last product, ``w_down``, whose
    output no gradient needs (the non-reentrant checkpoint stops its
    recompute once the saved tensors are back)."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    jparams = JT.init_params(jax.random.PRNGKey(0), jax_reduced(jax_get_config("tinyllama-1.1b")))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    f_none, b_none = _matmul_flops(cfg, params, batch, False)
    f_dots, b_dots = _matmul_flops(cfg, params, batch, "dots")
    f_true, b_true = _matmul_flops(cfg, params, batch, True)
    assert f_none == f_dots == f_true
    assert b_dots == b_none
    head = 2 * B * S * cfg.d_model * cfg.vocab
    w_down = 2 * B * S * cfg.d_ff * cfg.d_model
    assert b_true - b_none == f_none - head - cfg.n_layers * w_down > 0
