"""The port's paged attention (its plain version, which CPU tensors reach
through ``ops``) against the JAX Pallas kernel in interpret mode and the JAX
oracle, on the same numpy inputs."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as cuda_paged

PAGED_CASES = [
    # b, h, kv, hd, page, max_pages, pool  (tests/test_kernels.py)
    (4, 8, 2, 64, 16, 8, 64),
    (2, 4, 4, 128, 32, 4, 16),
    (3, 6, 6, 32, 8, 16, 128),
    (1, 16, 8, 64, 64, 4, 8),
]
DTYPES = {"float32": (jnp.float32, 2e-5), "bfloat16": (jnp.bfloat16, 3e-2)}


def _inputs(case, jdt, seed, lengths=None):
    """JAX arrays from a numpy seed, and the same values as torch tensors."""
    b, h, kv, hd, page, maxp, pool = case
    rng = np.random.default_rng(seed)
    j = {
        "q": jnp.asarray(rng.normal(size=(b, h, hd)).astype(np.float32), jdt),
        "k": jnp.asarray(rng.normal(size=(pool, page, kv, hd)).astype(np.float32), jdt),
        "v": jnp.asarray(rng.normal(size=(pool, page, kv, hd)).astype(np.float32), jdt),
        "table": jnp.asarray(rng.integers(0, pool, size=(b, maxp)), jnp.int32),
        "lengths": jnp.asarray(rng.integers(1, maxp * page, size=(b,))
                               if lengths is None else lengths, jnp.int32),
    }
    t = {k: tensor_from_numpy(np.asarray(a)) for k, a in j.items()}
    return j, t


def _port(t, softcap=0.0):
    return ops.paged_attention(t["q"], t["k"], t["v"], t["table"], t["lengths"],
                               softcap=softcap)


def _close(out, want, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_attention_matches_jax_kernel_and_ref(case, dtype):
    jdt, tol = DTYPES[dtype]
    j, t = _inputs(case, jdt, seed=PAGED_CASES.index(case))
    out = _port(t)
    assert out.dtype == t["q"].dtype and out.shape == t["q"].shape
    _close(out, jax_paged(j["q"], j["k"], j["v"], j["table"], j["lengths"],
                          interpret=True), tol)
    _close(out, jref.paged_attention_ref(j["q"], j["k"], j["v"], j["table"],
                                         j["lengths"]), tol)


def test_paged_attention_softcap():
    case = (2, 4, 2, 32, 8, 4, 16)
    j, t = _inputs(case, jnp.float32, seed=11, lengths=[5, 30])
    out = _port(t, softcap=30.0)
    _close(out, jax_paged(j["q"], j["k"], j["v"], j["table"], j["lengths"],
                          softcap=30.0, interpret=True), 2e-5)
    _close(out, jref.paged_attention_ref(j["q"], j["k"], j["v"], j["table"],
                                         j["lengths"], softcap=30.0), 2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_attention_length_zero_and_page_edges(dtype):
    """Length 0 gives 0 as the Pallas kernel does (the JAX ref averages V
    there, so it is not the oracle for that row); lengths on page edges."""
    jdt, tol = DTYPES[dtype]
    case = (5, 4, 2, 16, 8, 4, 16)
    j, t = _inputs(case, jdt, seed=12, lengths=[0, 1, 8, 9, 32])
    out = _port(t)
    assert torch.all(out[0] == 0)
    _close(out, jax_paged(j["q"], j["k"], j["v"], j["table"], j["lengths"],
                          interpret=True), tol)


def test_ops_sends_cpu_tensors_to_the_plain_version():
    before = cuda_paged.paged_attention.launches
    _, t = _inputs(PAGED_CASES[0], jnp.float32, seed=0)
    _port(t)
    assert cuda_paged.paged_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    _, t = _inputs(PAGED_CASES[0], jnp.float32, seed=0)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cuda_paged.paged_attention(t["q"], t["k"], t["v"], t["table"], t["lengths"])
