"""The port's SA-cache twin (``repro_torch.core.sa_cache``) against the JAX
twin (``repro.core.sa_cache``, carried across with ``cache_state_from_jax``)
and the numpy policies (``repro.core.policies``): ports of the ``sa_cache``
tests of ``tests/test_sa_cache.py`` and ``tests/test_policies.py``, on
numpy-seeded states. Exact equality throughout: the twin is integer math."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import policies
from repro.core import sa_cache as J
from repro_torch.convert import cache_state_from_jax
from repro_torch.core import sa_cache as S
from repro_torch.launch import quickstart


def _same(state, jstate):
    """Every field of the port's state equals the JAX state's."""
    want = cache_state_from_jax(jstate)
    for name in S.CacheState._fields:
        got, exp = getattr(state, name), getattr(want, name)
        if exp is None:
            assert got is None, name
        else:
            assert got.dtype == exp.dtype and torch.equal(got, exp), name


def _random_states(rng, num_sets, ss):
    """A JAX state and its twin: each set with random hits, hand, valid and
    dirty slots (dirty only where valid), tags distinct per set."""
    valid = rng.random((num_sets, ss)) > 0.3
    tags = np.where(valid, np.arange(num_sets * ss).reshape(num_sets, ss), -1)
    jstate = J.CacheState(
        tags=jnp.asarray(tags, jnp.int32),
        hits=jnp.asarray(rng.integers(0, 16, size=(num_sets, ss)), jnp.int32),
        dirty=jnp.asarray((rng.random((num_sets, ss)) > 0.5) & valid),
        clock=jnp.asarray(rng.integers(0, ss, size=(num_sets,)), jnp.int32),
        epoch=jnp.asarray(rng.integers(0, 4, size=(num_sets, ss)), jnp.int32))
    return jstate, cache_state_from_jax(jstate)


# ---------------------------------------------------------------------------
# scoring over all sets (tests/test_policies.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ss", [2, 7, 12, 16])
def test_flush_scores_match_jax_twin_and_policies(ss):
    jstate, state = _random_states(np.random.default_rng(ss), 64, ss)
    fs = S.flush_scores(state)
    np.testing.assert_array_equal(fs.numpy(), np.asarray(J.flush_scores(jstate)))
    np.testing.assert_array_equal(S.distance_scores(state).numpy(),
                                  np.asarray(J.distance_scores(jstate)))
    np.testing.assert_array_equal(S.dirty_counts(state).numpy(),
                                  np.asarray(J.dirty_counts(jstate)))
    valid = (state.tags != S.EMPTY).numpy()
    for i in range(64):
        want = policies.flush_scores(state.hits[i].numpy().astype(np.int64),
                                     int(state.clock[i]), valid=valid[i])
        np.testing.assert_array_equal(fs[i].numpy(), want)
        # the valid slots hold the top n scores, each once; empty slots -1
        n = int(valid[i].sum())
        assert sorted(fs[i].numpy()[valid[i]]) == list(range(ss - n, ss))
        assert (fs[i].numpy()[~valid[i]] == -1).all()


@pytest.mark.parametrize("trigger,per_set", [(0, 2), (2, 1), (3, 4), (0, 12)])
def test_select_flush_candidates_match_jax_twin(trigger, per_set):
    """Equal outputs although ``torch.topk`` promises no order among equal
    values: a set's valid scores are distinct, so only the -1s tie, and their
    slots are -1. Sets with fewer dirty pages than ``per_set`` (and per_set
    = set_size) make those ties."""
    jstate, state = _random_states(np.random.default_rng(per_set), 200, 12)
    got = S.select_flush_candidates(state, trigger, per_set)
    want = J.select_flush_candidates(jstate, trigger, per_set)
    assert int((got[1] == -1).sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# eviction (tests/test_policies.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ss", [2, 5, 12, 16])
def test_insert_victim_matches_oracle_and_jax_twin(ss):
    rng = np.random.default_rng(100 + ss)
    for _ in range(12):
        jstate, state = _random_states(rng, 1, ss)
        hits, clock = state.hits[0].numpy().astype(np.int64), int(state.clock[0])
        valid = (state.tags[0] != S.EMPTY).numpy()
        dirty = state.dirty[0].numpy()
        ref_victim, ref_hits, ref_clock = policies.gclock_evict(
            hits, clock, valid, dirty, clean_first=True)
        vt, vd, slot, new = S.insert(state, 0, 1000, False)
        jvt, jvd, jslot, jnew = J.insert(jstate, jnp.int32(0), jnp.int32(1000),
                                         jnp.bool_(False))
        assert int(slot) == ref_victim == int(jslot)
        assert int(new.clock[0]) == ref_clock
        ref_hits[ref_victim] = 0
        np.testing.assert_array_equal(new.hits[0].numpy(), ref_hits)
        assert (int(vt), bool(vd)) == (int(jvt), bool(jvd))
        _same(new, jnew)


def test_evict_analytic_clean_first_off_matches_jax_twin():
    rng = np.random.default_rng(7)
    for _ in range(20):
        jstate, state = _random_states(rng, 1, 12)
        args = [state.hits[0], state.clock[0], state.tags[0] != S.EMPTY, state.dirty[0]]
        jargs = [jstate.hits[0], jstate.clock[0], jstate.tags[0] != J.EMPTY, jstate.dirty[0]]
        got = S._evict_analytic(*args, clean_first=False)
        want = J._evict_analytic(*jargs, clean_first=False)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lookup_bumps_hits_saturating():
    cache = S.make_cache(2, 4)
    _, _, slot, cache = S.insert(cache, 0, 7, False)
    for _ in range(20):
        hit, s2, cache = S.lookup(cache, 0, 7)
        assert bool(hit) and int(s2) == int(slot)
    assert int(cache.hits[0, slot]) == S.MAX_HITS
    hit, _, after = S.lookup(cache, 1, 7)          # a miss changes nothing
    assert not bool(hit) and torch.equal(after.hits, cache.hits)


def test_clean_slot_ignores_reused_slot():
    cache = S.make_cache(1, 4)
    _, _, slot, cache = S.insert(cache, 0, 5, True)
    tags = cache.tags.clone()
    tags[0, slot] = 9                              # tag replaced before completion
    cache = S.clean_slot(cache._replace(tags=tags), 0, slot, expect_tag=5)
    assert bool(cache.dirty[0, slot])              # stays dirty: the flush was stale


# ---------------------------------------------------------------------------
# dirty epochs (tests/test_sa_cache.py), each step held to the JAX twin
# ---------------------------------------------------------------------------

def test_clean_slot_epoch_mismatch_keeps_dirty():
    cache, jcache = S.make_cache(1, 4), J.make_cache(1, 4)
    _, _, slot, cache = S.insert(cache, 0, 5, True)
    _, _, jslot, jcache = J.insert(jcache, jnp.int32(0), jnp.int32(5), jnp.bool_(True))
    issued = int(S.dirty_epoch_of(cache, 0, slot))
    assert issued == int(J.dirty_epoch_of(jcache, 0, jslot))
    cache = S.mark_dirty(cache, 0, slot, True)     # a write while the flush is in flight
    jcache = J.mark_dirty(jcache, 0, jslot, True)
    cache = S.clean_slot(cache, 0, slot, expect_tag=5, expect_epoch=issued)
    jcache = J.clean_slot(jcache, 0, jslot, expect_tag=5, expect_epoch=issued)
    assert bool(cache.dirty[0, slot]), "newer write must not be dropped"
    _same(cache, jcache)
    cache = S.clean_slot(cache, 0, slot, expect_tag=5,
                         expect_epoch=int(S.dirty_epoch_of(cache, 0, slot)))
    assert not bool(cache.dirty[0, slot])


def test_clean_slot_same_tag_reinserted_stays_dirty():
    cache = S.make_cache(1, 1)                     # one slot: reuse guaranteed
    _, _, slot, cache = S.insert(cache, 0, 5, True)
    issued = int(S.dirty_epoch_of(cache, 0, slot))
    _, _, _, cache = S.insert(cache, 0, 9, True)   # evicts tag 5
    _, _, _, cache = S.insert(cache, 0, 5, True)   # tag 5 back, new content
    cache = S.clean_slot(cache, 0, slot, expect_tag=5, expect_epoch=issued)
    assert bool(cache.dirty[0, slot])


def test_clean_slot_without_epoch_matches_legacy_rule():
    cache = S.make_cache(1, 4)
    _, _, slot, cache = S.insert(cache, 0, 5, True)
    cache = S.clean_slot(cache, 0, slot, expect_tag=5)
    assert not bool(cache.dirty[0, slot])


def test_legacy_state_without_epoch_field_still_works():
    cache = S.CacheState(tags=torch.full((1, 4), S.EMPTY, dtype=torch.int32),
                         hits=torch.zeros((1, 4), dtype=torch.int32),
                         dirty=torch.zeros((1, 4), dtype=torch.bool),
                         clock=torch.zeros((1,), dtype=torch.int32))
    _, _, slot, cache = S.insert(cache, 0, 7, True)
    assert cache.epoch is None
    hit, s2, cache = S.lookup(cache, 0, 7)
    assert bool(hit) and int(s2) == int(slot)
    cache = S.mark_dirty(cache, 0, slot, True)
    cache = S.clean_slot(cache, 0, slot, expect_tag=7, expect_epoch=3)
    assert not bool(cache.dirty[0, slot])          # epoch check off: the tag rules


def test_epoch_bumps_on_insert_and_mark_dirty():
    cache = S.make_cache(2, 4)
    _, _, slot, cache = S.insert(cache, 1, 3, False)
    e0 = int(cache.epoch[1, slot])
    cache = S.mark_dirty(cache, 1, slot, True)
    cache = S.mark_dirty(cache, 1, slot, True)     # every write is a new version
    assert int(cache.epoch[1, slot]) == e0 + 2
    cache = S.mark_dirty(cache, 1, slot, False)    # cleaning is not a version
    assert int(cache.epoch[1, slot]) == e0 + 2


# ---------------------------------------------------------------------------
# sequences of ops, and the state -> state contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_op_sequence_matches_jax_twin_and_leaves_inputs_alone(seed):
    """A random mix of insert / lookup / mark_dirty / clean_slot on both
    twins: equal states after every op, and the state an op was given is
    unchanged afterwards (JAX's arrays are immutable; the port copies)."""
    rng = np.random.default_rng(seed)
    ns, ss = 3, 4
    cache, jcache = S.make_cache(ns, ss), J.make_cache(ns, ss)
    for _ in range(60):
        op = rng.choice(["insert", "insert", "lookup", "dirty", "clean"])
        s, tag, slot = int(rng.integers(ns)), int(rng.integers(40)), int(rng.integers(ss))
        given, before = cache, [t.clone() for t in cache]
        if op == "insert":
            if bool((cache.tags[s] == tag).any()):
                continue                            # insert wants an absent tag
            d = bool(rng.integers(2))
            got = S.insert(cache, s, tag, d)
            want = J.insert(jcache, jnp.int32(s), jnp.int32(tag), jnp.bool_(d))
            assert [int(x) for x in got[:3]] == [int(x) for x in want[:3]]
            cache, jcache = got[3], want[3]
        elif op == "lookup":
            got = S.lookup(cache, s, tag)
            want = J.lookup(jcache, jnp.int32(s), jnp.int32(tag))
            assert [int(x) for x in got[:2]] == [int(x) for x in want[:2]]
            cache, jcache = got[2], want[2]
        elif op == "dirty":
            cache = S.mark_dirty(cache, s, slot, True)
            jcache = J.mark_dirty(jcache, s, slot, True)
        else:
            t, e = int(cache.tags[s, slot]), int(cache.epoch[s, slot]) - int(rng.integers(2))
            cache = S.clean_slot(cache, s, slot, expect_tag=t, expect_epoch=e)
            jcache = J.clean_slot(jcache, s, slot, expect_tag=t, expect_epoch=e)
        _same(cache, jcache)
        assert all(torch.equal(a, b) for a, b in zip(given, before))
    np.testing.assert_array_equal(S.flush_scores(cache).numpy(),
                                  np.asarray(J.flush_scores(jcache)))


def test_quickstart_twin_matches_jax_quickstart():
    """Parts 1-2 of examples/quickstart.py: the same cache and scores as the
    JAX twin, and the HIGH request overtakes the flush backlog."""
    res = quickstart.main(["--device", "cpu"])
    jcache = J.make_cache(num_sets=4, set_size=12)
    for tag in range(40):
        _, _, _, jcache = J.insert(jcache, jnp.int32(tag % 4), jnp.int32(tag),
                                   jnp.bool_(tag % 3 == 0))
    _same(res["cache"], jcache)
    np.testing.assert_array_equal(res["scores"], np.asarray(J.flush_scores(jcache)))
    assert res["first"] == "application read"
    assert res["requests"] and all(r.score_at_issue >= 0 for r in res["requests"])
