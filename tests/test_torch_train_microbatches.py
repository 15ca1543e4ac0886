"""The port's train step with 2 microbatches against the JAX package's
``make_train_step(..., microbatches=2)``, and remat against no remat, for
the six reduced archs of tests/test_torch_train_steps.py (its helpers,
loaded by path)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import make_grad_fn, make_train_step
from repro_torch.tree import leaves

_spec = importlib.util.spec_from_file_location(
    "torch_train_steps_helpers", Path(__file__).resolve().parent / "test_torch_train_steps.py")
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)


@pytest.fixture(scope="module", params=S.ARCHS)
def model(request):
    arch = request.param
    jcfg = jax_reduced(jax_get_config(arch))
    return arch, reduced(get_config(arch)), jcfg, JT.init_params(jax.random.PRNGKey(0), jcfg)


def test_microbatches_and_remat(model):
    """``microbatches=2`` equals JAX's step with 2 (2 steps: ce, grad norm
    and the updates); ``remat=True`` gives ``remat=False``'s gradient."""
    arch, cfg, jcfg, jparams = model
    batches = S._batches(cfg, 2)
    jstep = jax.jit(JS.make_train_step(jcfg, None, remat=False, microbatches=2, **S.HP))
    step = make_train_step(cfg, remat=False, microbatches=2, **S.HP)
    jp, js = jparams, jax_adamw_init(jparams)
    params, opt = S._port_state(jparams)
    for b in batches:
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        params, opt, met = step(params, opt, S._torch_batch(b))
        for k in ("ce", "grad_norm"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4)
    for p, j0, j in zip(leaves(params), jax.tree.leaves(jparams), jax.tree.leaves(jp)):
        assert S._rel_l2(p.numpy() - np.asarray(j0), np.asarray(j) - np.asarray(j0)) <= 1e-3

    params, _ = S._port_state(jparams)
    tb = S._torch_batch(batches[0])
    want, wm = make_grad_fn(cfg, remat=False)(params, tb)
    got, gm = make_grad_fn(cfg, remat=True)(params, tb)
    assert float(gm["ce"]) == pytest.approx(float(wm["ce"]), rel=1e-6)
    for g, w in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
