"""The arithmetic of the flush kernel's set design (``kernels/csrc/flush_score.cu``),
rehearsed on the CPU.

``_set_design`` repeats what one thread of the set design does for its set,
vectorised over sets in numpy: the distance ``(slot - clock) mod ss`` as C's
truncating remainder by the constant ``ss`` on the wrapped int32 difference,
plus ``ss`` when negative; ``d = hits * ss + dist`` wrapping in 32 bits;
``INT32_MAX`` for an empty slot; and the scores from one compare per
unordered pair of slots (``i < j``: ``c = d_i <= d_j``, slot ``i`` before slot
``j`` when ``c``; ``score_i += c``, ``score_j -= c`` from ``score_k = k``, which
is ``ss - 1 - rank_k``). It is held, exactly, to the interpret-mode Pallas kernel
and to the port's plain version on the int32 edges that ``chip_smoke.py``
also gives the kernel on the card (clocks at and above ``INT32_MIN``, ``-1``,
``0``, ``INT32_MAX``; hits that wrap, at ``INT32_MAX``, negative; empty sets;
a valid ``d`` of ``INT32_MAX``; all-equal ``d``), at every set size the set
design instantiates (1-16) and at the slot design's 17, 64 and 256.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from repro.kernels.flush_score import flush_scores as jax_flush
from repro_torch.kernels import ref

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

INT32_MIN, INT32_MAX = chip_smoke.INT32_MIN, chip_smoke.INT32_MAX
SET_SIZES = [*range(1, 17), 17, 64, 256]


def _set_design(hits, clock, valid):
    """(scores, ranks) of the set design, int32 (ns, ss) each; an empty
    slot's score is -1, its rank that of d = INT32_MAX."""
    ns, ss = hits.shape
    h, c = hits.astype(np.uint32), clock.astype(np.uint32)
    d = np.empty((ns, ss), np.int32)
    for k in range(ss):
        diff = (np.uint32(k) - c).astype(np.int32)            # wraps
        dist = np.fmod(diff, np.int32(ss))                     # C's %, toward zero
        dist = dist + np.where(dist < 0, np.int32(ss), np.int32(0))
        score = (h[:, k] * np.uint32(ss) + dist.astype(np.uint32)).astype(np.int32)
        d[:, k] = np.where(valid[:, k], score, np.int32(INT32_MAX))
    score = np.broadcast_to(np.arange(ss, dtype=np.int32), (ns, ss)).copy()
    for i in range(ss):
        for j in range(i + 1, ss):
            before = (d[:, i] <= d[:, j]).astype(np.int32)
            score[:, i] += before
            score[:, j] -= before
    return np.where(valid, score, np.int32(-1)), ss - 1 - score


def _pallas(hits, clock, valid):
    return np.asarray(jax_flush(jnp.asarray(hits), jnp.asarray(clock), jnp.asarray(valid),
                                block_sets=128, interpret=True))


def _plain(hits, clock, valid):
    return ref.flush_scores_ref(*(torch.from_numpy(a) for a in (hits, clock, valid))).numpy()


def _check(hits, clock, valid):
    got, rank = _set_design(hits, clock, valid)
    np.testing.assert_array_equal(got, _plain(hits, clock, valid))
    np.testing.assert_array_equal(got, _pallas(hits, clock, valid))
    np.testing.assert_array_equal(np.sort(rank, axis=1), np.broadcast_to(
        np.arange(hits.shape[1], dtype=np.int32), hits.shape))


@pytest.mark.parametrize("ss", SET_SIZES)
def test_set_design_on_int32_edges(ss):
    hits, clock, valid = chip_smoke.flush_edge_arrays(2 * ss + 40, ss, np.random.default_rng(ss))
    _check(hits, clock, valid)


@pytest.mark.parametrize("ns", [1, 127, 128, 129])
@pytest.mark.parametrize("ss", [7, 12])
def test_set_design_around_a_block(ns, ss):
    """A block of the set design holds 128 sets: one short of it, one, one past."""
    _check(*chip_smoke.flush_edge_arrays(ns, ss, np.random.default_rng(ns + ss)))


@pytest.mark.parametrize("ss", SET_SIZES)
def test_edge_arrays_hold_the_edges(ss):
    """The edge sets are there: every clock edge, a valid slot with d at
    INT32_MAX, an empty set, and at odd ss a set of all-equal d."""
    hits, clock, valid = chip_smoke.flush_edge_arrays(2 * ss + 40, ss, np.random.default_rng(ss))
    for c in (INT32_MIN, *range(INT32_MIN + 1, INT32_MIN + ss + 1), -1, 0, INT32_MAX):
        assert c in clock
    assert (~valid).all(axis=1).any()
    dist = np.mod(np.arange(ss)[None, :] - clock.astype(np.int64)[:, None], ss)
    d = (hits.astype(np.int64) * ss + dist + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert ((d == INT32_MAX) & valid).any()
    if ss % 2 and ss > 1:
        assert ((d == d[:, :1]) & valid).all(axis=1).any()


def test_edges_catch_an_unsafe_mod_shortcut():
    """(mod(-clock, ss) + slot) mod ss, a per-set shortcut, is wrong where
    slot - clock wraps (clock in INT32_MIN .. INT32_MIN + slot); the edge
    inputs show it."""
    ss = 12
    hits, clock, valid = chip_smoke.flush_edge_arrays(64, ss, np.random.default_rng(1))
    m0 = np.mod(-clock.astype(np.int64), ss)
    dist = (m0[:, None] + np.arange(ss)[None, :]) % ss
    d = ((hits.astype(np.int64) * ss + dist) % 2 ** 32).astype(np.uint32).astype(np.int32)
    d = np.where(valid, d, INT32_MAX)
    lt = (d[:, None, :] < d[:, :, None]) | ((d[:, None, :] == d[:, :, None])
                                            & (np.arange(ss)[None, None, :]
                                               < np.arange(ss)[None, :, None]))
    shortcut = np.where(valid, ss - 1 - lt.sum(-1), -1)
    assert (shortcut != _plain(hits, clock, valid)).any()
    np.testing.assert_array_equal(_set_design(hits, clock, valid)[0], _plain(hits, clock, valid))


@settings(max_examples=200, deadline=None)
@given(data=st.data(), ss=st.integers(1, 16), ns=st.integers(1, 9))
def test_set_design_ranks_are_a_permutation(data, ss, ns):
    """Over random full-range int32 inputs the ranks of a set are a
    permutation of 0..ss-1, and the scores equal the plain version's."""
    i32 = hnp.from_dtype(np.dtype(np.int32))
    hits = data.draw(hnp.arrays(np.int32, (ns, ss), elements=i32))
    clock = data.draw(hnp.arrays(np.int32, (ns,), elements=i32))
    valid = data.draw(hnp.arrays(np.bool_, (ns, ss)))
    got, rank = _set_design(hits, clock, valid)
    assert (np.sort(rank, axis=1) == np.arange(ss)).all()
    np.testing.assert_array_equal(got, _plain(hits, clock, valid))


def test_set_design_range_is_one_source():
    """The set sizes the .cu instantiates, its kMaxSetSize and the card
    checks' FLUSH_SET_MAX agree."""
    src = (Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/flush_score.cu"
           ).read_text()
    limit = int(re.search(r"constexpr int kMaxSetSize = (\d+);", src).group(1))
    cases = sorted(int(n) for n in re.findall(r"REPRO_SET_CASE\((\d+)\)", src))
    assert limit == chip_smoke.FLUSH_SET_MAX == 16
    assert cases == list(range(1, limit + 1))
