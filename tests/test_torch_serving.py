"""The port's serving engine: exactness vs dense decode, pool pressure,
flusher effect, and agreement with the JAX engine and allocator (reduced
tinyllama, weights converted from the JAX init)."""
import numpy as np
import pytest

import jax
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving.kv_pool import PagedAllocator as JaxPagedAllocator
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine
from repro_torch.serving.kv_pool import PagedAllocator


def _dense_greedy(params, cfg, prompt, n):
    toks = torch.tensor([prompt])
    last, cache = T.prefill(params, toks, cfg, max_seq=128)
    out = []
    t = last[:, -1, :].argmax(-1)[:, None]
    for _ in range(n):
        out.append(int(t[0, 0]))
        lg, cache = T.decode_step(params, t, cache, cfg)
        t = lg[:, -1, :].argmax(-1)[:, None]
    return out


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = jax_reduced(jax_get_config("tinyllama-1.1b"))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = reduced(get_config("tinyllama-1.1b"))
    return cfg, params_from_jax(jax.tree.map(np.asarray, jparams)), jcfg, jparams


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, params, device="cpu", **kw)


PROMPTS = [[5, 7, 11, 13, 17], [2, 3], [21, 22, 23, 24, 25, 26, 27, 28, 29]]


def test_engine_matches_dense_decode(tiny_model):
    cfg, params, _, _ = tiny_model
    eng = _engine(cfg, params, max_batch=3, page_size=8, num_sets=16, set_size=4)
    rids = [eng.submit(p, max_new=10) for p in PROMPTS]
    eng.run(200)
    for rid, p in zip(rids, PROMPTS):
        assert eng.result(rid).out == _dense_greedy(params, cfg, p, 10)
    eng.close()


def test_engine_tokens_match_jax_engine(tiny_model):
    cfg, params, jcfg, jparams = tiny_model
    eng = _engine(cfg, params, max_batch=3, page_size=8, num_sets=16, set_size=4)
    jeng = JaxServeEngine(jcfg, jparams, max_batch=3, page_size=8, num_sets=16,
                          set_size=4)
    rids = [eng.submit(p, max_new=10) for p in PROMPTS]
    jrids = [jeng.submit(p, max_new=10) for p in PROMPTS]
    eng.run(200)
    jeng.run(200)
    for rid, jrid in zip(rids, jrids):
        assert eng.result(rid).out == jeng.result(jrid).out
    eng.close()
    jeng.close()


def test_engine_exact_under_pool_pressure(tiny_model):
    """Preemption + offload + resume must be lossless."""
    cfg, params, _, _ = tiny_model
    eng = _engine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3)
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 250, int(rng.integers(3, 20)))]
               for _ in range(6)]
    rids = [eng.submit(p, max_new=24) for p in prompts]
    eng.run(800)
    st = eng.stats()
    assert st["preemptions"] > 0, "test must exercise the pressure path"
    assert st["offloads"] > 0 and st["fetches"] > 0
    for rid, p in zip(rids, prompts):
        r = eng.result(rid)
        assert r.state == "done"
        assert r.out == _dense_greedy(params, cfg, p, 24), f"rid{rid}"
    eng.close()


def test_flusher_precleaning_reduces_blocking_offloads(tiny_model):
    """Background pre-cleaning turns blocking (dirty) evictions into instant
    (clean) ones."""
    cfg, params, _, _ = tiny_model
    results = {}
    for use_flusher in (True, False):
        eng = _engine(cfg, params, max_batch=4, page_size=8, num_sets=4,
                      set_size=3, use_flusher=use_flusher)
        rng = np.random.default_rng(5)
        prompts = [[int(x) for x in rng.integers(1, 250, 16)] for _ in range(8)]
        rids = [eng.submit(p, max_new=24) for p in prompts]
        eng.run(1200)
        assert all(eng.result(r).state == "done" for r in rids)
        results[use_flusher] = eng.stats()
        eng.close()
    assert results[True]["offloads"] > 0
    assert results[True]["clean_evictions"] >= results[False]["clean_evictions"]
    assert results[True]["blocking_offloads"] <= results[False]["blocking_offloads"]


def test_allocator_never_evicts_pinned():
    a = PagedAllocator(num_sets=2, set_size=2)
    tags = []
    t = 0
    while len(tags) < 4:
        pid, ev, _ = a.alloc(t)
        if pid is not None:
            tags.append(t)
        t += 1
        if t > 100:
            break
    before = dict(a.where)
    for tt in range(200, 260):
        pid, ev, _ = a.alloc(tt)
        if pid is not None:
            pytest.fail("alloc succeeded in fully pinned pool")
    assert dict(a.where) == before
    a.set_pinned([tags[0]], False)
    s = a.set_of(tags[0])
    for tt in range(300, 400):
        if a.set_of(tt) == s:
            pid, ev, _ = a.alloc(tt)
            assert pid is not None and ev == tags[0]
            break


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_decisions_match_jax_package(seed):
    """The copied control plane makes the same placement and eviction
    decisions as ``repro.serving.kv_pool.PagedAllocator``."""
    rng = np.random.default_rng(seed)
    mine, theirs = PagedAllocator(num_sets=4, set_size=3), JaxPagedAllocator(4, 3)
    live: list[int] = []
    for step in range(600):
        op = rng.choice(["alloc"] * 4 + ["touch", "full", "clean", "pin", "unpin", "free"])
        tags = [int(x) for x in rng.choice(live, size=min(len(live), 3), replace=False)] \
            if live else []
        if op == "alloc":
            tag = int(rng.integers(0, 5000))
            got, want = mine.alloc(tag), theirs.alloc(tag)
            assert got == want, step
            if got[0] is not None:
                live.append(tag)
            if got[1] is not None and got[1] in live:
                live.remove(got[1])
        elif op == "touch":
            mine.touch(tags), theirs.touch(tags)
        elif op == "full":
            for t in tags:
                mine.mark_full(t), theirs.mark_full(t)
        elif op == "clean":
            for t in tags:
                mine.mark_clean(t), theirs.mark_clean(t)
        elif op in ("pin", "unpin"):
            mine.set_pinned(tags, op == "pin"), theirs.set_pinned(tags, op == "pin")
        else:
            mine.free(tags), theirs.free(tags)
            live = [t for t in live if t not in tags]
        for name in ("tags", "hits", "dirty", "pinned", "full", "clock"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))
        assert mine.where == theirs.where
        for s in range(4):
            assert mine.flush_candidates(s) == theirs.flush_candidates(s)
    assert vars(mine.stats) == vars(theirs.stats)
    st = mine.stats          # the sequence reached evictions and refusals
    assert st.clean_evictions and st.dirty_evictions and st.alloc_failures
