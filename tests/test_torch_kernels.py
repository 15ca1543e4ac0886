"""The port's kernels (their plain versions, which CPU tensors reach through
``ops``) against the JAX Pallas kernels in interpret mode, the JAX oracles and
the numpy policy, on the same numpy inputs."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import policies as jpolicies
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flush_score import flush_scores as jax_flush
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import flash_attention as cuda_flash
from repro_torch.kernels import flush_score as cuda_flush
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


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_attention_head_dim_120(dtype):
    """h2o-danube's heads (H 32, KV 8, hd 120, page 16), which the kernel
    compiles since the plain version and the Pallas kernel agree there."""
    jdt, tol = DTYPES[dtype]
    j, t = _inputs((2, 32, 8, 120, 16, 4, 12), jdt, seed=13)
    out = _port(t)
    assert out.shape == (2, 32, 120)
    _close(out, jax_paged(j["q"], j["k"], j["v"], j["table"], j["lengths"],
                          interpret=True), tol)


def test_ops_sends_cpu_tensors_to_the_plain_version():
    before = (cuda_paged.paged_attention.launches, cuda_flash.flash_attention.launches,
              cuda_flush.flush_scores.launches)
    _, t = _inputs(PAGED_CASES[0], jnp.float32, seed=0)
    _port(t)
    _, f = _flash_inputs(FLASH_CASES[0], jnp.float32, seed=0)
    ops.flash_attention(f["q"], f["k"], f["v"])
    _, g = _flush_inputs(10, 12, seed=0)
    ops.flush_scores(g["hits"], g["clock"], g["valid"])
    assert (cuda_paged.paged_attention.launches, cuda_flash.flash_attention.launches,
            cuda_flush.flush_scores.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    _, t = _inputs(PAGED_CASES[0], jnp.float32, seed=0)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cuda_paged.paged_attention(t["q"], t["k"], t["v"], t["table"], t["lengths"])
    _, f = _flash_inputs(FLASH_CASES[0], jnp.float32, seed=0)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cuda_flash.flash_attention(f["q"], f["k"], f["v"])
    _, g = _flush_inputs(10, 12, seed=0)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cuda_flush.flush_scores(g["hits"], g["clock"], g["valid"])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # b, sq, skv, h, kv, hd, causal, window, softcap  (tests/test_kernels.py)
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 256, 256, 8, 8, 64, True, 64, 50.0),       # SWA + softcap (gemma2)
    (2, 64, 192, 4, 1, 128, False, 0, 0.0),        # MQA cross-shape
    (1, 100, 100, 2, 2, 32, True, 0, 0.0),         # non-multiple-of-block
    (1, 16, 144, 6, 6, 64, True, 0, 0.0),          # MHA (whisper-like)
    (3, 128, 128, 8, 4, 16, True, 32, 0.0),
]
FLASH_DTYPES = {"float32": (jnp.float32, 2e-5), "bfloat16": (jnp.bfloat16, 2e-2)}


def _flash_inputs(case, jdt, seed):
    b, sq, skv, h, kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    j = {"q": jnp.asarray(rng.normal(size=(b, sq, h, hd)).astype(np.float32), jdt),
         "k": jnp.asarray(rng.normal(size=(b, skv, kv, hd)).astype(np.float32), jdt),
         "v": jnp.asarray(rng.normal(size=(b, skv, kv, hd)).astype(np.float32), jdt)}
    return j, {k: tensor_from_numpy(np.asarray(a)) for k, a in j.items()}


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_attention_matches_jax_ref(case, dtype):
    jdt, tol = FLASH_DTYPES[dtype]
    causal, window, cap = case[6:]
    j, t = _flash_inputs(case, jdt, seed=FLASH_CASES.index(case))
    out = ops.flash_attention(t["q"], t["k"], t["v"], causal=causal, window=window,
                              softcap=cap)
    assert out.dtype == t["q"].dtype and out.shape == t["q"].shape
    _close(out, jref.flash_attention_ref(j["q"], j["k"], j["v"], causal=causal,
                                         window=window, softcap=cap), tol)


@pytest.mark.parametrize("case", FLASH_CASES[:2])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_attention_matches_jax_kernel(case, dtype):
    jdt, tol = FLASH_DTYPES[dtype]
    causal, window, cap = case[6:]
    j, t = _flash_inputs(case, jdt, seed=FLASH_CASES.index(case))
    out = ops.flash_attention(t["q"], t["k"], t["v"], causal=causal, window=window,
                              softcap=cap)
    _close(out, jax_flash(j["q"], j["k"], j["v"], causal=causal, window=window,
                          softcap=cap, block_q=64, block_kv=64, interpret=True), tol)


def test_flash_attention_q_offset_decode_tail():
    """Chunked decode: q is a tail slice at offset 48 into the kv history."""
    j, t = _flash_inputs((1, 64, 64, 4, 4, 32), jnp.float32, seed=21)
    tail = ops.flash_attention(t["q"][:, 48:], t["k"], t["v"], causal=True, q_offset=48)
    _close(tail, jax_flash(j["q"][:, 48:], j["k"], j["v"], causal=True, q_offset=48,
                           block_q=16, block_kv=16, interpret=True), 2e-5)
    full = jref.flash_attention_ref(j["q"], j["k"], j["v"], causal=True)
    _close(tail, full[:, 48:], 2e-5)


def test_flash_attention_rows_without_keys_give_zero():
    """Window and offset put every key out of reach of the rows past the
    third: those rows are 0, as the Pallas kernel and the JAX oracle make
    them."""
    j, t = _flash_inputs((1, 8, 16, 2, 1, 16), jnp.float32, seed=22)
    kw = dict(causal=True, window=4, q_offset=16)    # row i sees keys 13+i .. 15
    out = ops.flash_attention(t["q"], t["k"], t["v"], **kw)
    assert torch.all(out[:, 3:] == 0) and torch.all(out[:, :3] != 0)
    _close(out, jref.flash_attention_ref(j["q"], j["k"], j["v"], **kw), 2e-5)


# ---------------------------------------------------------------------------
# flush scores
# ---------------------------------------------------------------------------

FLUSH_GRID = [(100, 12), (1000, 12), (64, 7), (513, 16), (1, 12), (256, 2)]


def _flush_inputs(ns, ss, seed, clock=None):
    rng = np.random.default_rng(seed)
    n = {"hits": rng.integers(0, 15, size=(ns, ss)).astype(np.int32),
         "clock": (rng.integers(0, ss, size=(ns,)) if clock is None else clock).astype(np.int32),
         "valid": rng.random((ns, ss)) > 0.3}
    return n, {k: torch.from_numpy(a) for k, a in n.items()}


@pytest.mark.parametrize("ns,ss", FLUSH_GRID)
def test_flush_scores_match_jax_kernel_ref_and_policies(ns, ss):
    n, t = _flush_inputs(ns, ss, seed=ns * 100 + ss)
    out = ops.flush_scores(t["hits"], t["clock"], t["valid"])
    assert out.dtype == torch.int32 and out.shape == (ns, ss)
    j = {k: jnp.asarray(a) for k, a in n.items()}
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jref.flush_scores_ref(j["hits"], j["clock"], j["valid"])))
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jax_flush(j["hits"], j["clock"], j["valid"], block_sets=128, interpret=True)))
    for i in range(ns):
        np.testing.assert_array_equal(out[i].numpy(), jpolicies.flush_scores(
            n["hits"][i], int(n["clock"][i]), valid=n["valid"][i]))


@pytest.mark.parametrize("ss", [12, 64])
def test_flush_scores_any_int32_clock(ss):
    """A hand anywhere in int32 (negative too) gives the non-negative mod of
    the JAX oracle, not C's remainder; and set_size up to 64."""
    rng = np.random.default_rng(ss)
    clock = rng.integers(-2 ** 31, 2 ** 31, size=(50,))
    n, t = _flush_inputs(50, ss, seed=ss, clock=clock)
    out = ops.flush_scores(t["hits"], t["clock"], t["valid"])
    want = jref.flush_scores_ref(*(jnp.asarray(n[k]) for k in ("hits", "clock", "valid")))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
