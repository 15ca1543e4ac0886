"""The serving engine's spans and counters (``serving/spans.py``) on a
reduced engine under pool pressure: ``stats()``'s keys against what the
engine ran, the profiler ranges (one from an IO thread), none without a
profiler; the ``IOExecutor``'s queue waits; and ``_free`` scanning the host
tier while an IO thread inserts into it."""
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from repro_torch.configs import get_config, reduced
from repro_torch.core.io_queues import HIGH, LOW, IOExecutor, IORequest
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import MAX_PAGES_PER_SEQ

WAIT_S = 30.0                 # the bound of every wait in this file


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced(get_config("tinyllama-1.1b"))
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0))


def _prompts(seed, n=6):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 250, int(rng.integers(3, 20)))]
            for _ in range(n)]


def _pressed(cfg, params):
    """An engine whose pool preempts: 4 rows over 4 sets of 3 pages of 8."""
    return ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4,
                       set_size=3, device="cpu")


@pytest.fixture(scope="module")
def pressed_run(tiny):
    """One run under pressure, each decode call's active rows counted on the
    way into ``step_fn``."""
    cfg, params = tiny
    eng = _pressed(cfg, params)
    step, rows = eng.step_fn, []

    def counted(*args):
        rows.append(len(args[-1]))
        return step(*args)
    eng.step_fn = counted
    prompts = _prompts(3)
    rids = [eng.submit(p, max_new=24) for p in prompts]
    eng.run(800)
    assert eng.pool.exec.drain(WAIT_S)
    assert all(eng.result(r).state == "done" for r in rids)
    st = eng.stats()
    eng.close()
    return st, rows, prompts


def test_stats_count_what_the_engine_ran(pressed_run):
    st, rows, prompts = pressed_run
    assert st["preemptions"] > 0 and st["blocking_offloads"] > 0
    assert st["decode_steps"] == len(rows) > 0
    assert st["decode_rows_active"] == sum(rows)
    assert st["decode_rows_computed"] == 4 * len(rows)
    assert st["prefill_tokens"] == sum(len(p) for p in prompts)
    assert st["offloads"] > 0 and st["offload_io_n"] > 0 and st["flush_issued"] > 0
    assert st["fetch_issued"] == st["fetches"] > 0


def test_stats_times_nest(pressed_run):
    st, _, _ = pressed_run
    for k, v in st.items():
        assert type(v) in (int, float), k
    times = {k: v for k, v in st.items() if k.endswith("_s")}
    assert set(times) >= {"decode_s", "decode_lock_s", "decode_launch_s", "prefill_s",
                          "blocking_offload_s", "fetch_wait_s", "offload_io_s",
                          "flush_wait_s", "fetch_queue_wait_s"}
    assert all(v >= 0 for v in times.values())
    assert st["decode_lock_s"] + st["decode_launch_s"] <= st["decode_s"]
    assert 0 < st["decode_launch_s"] and 0 < st["prefill_s"] and 0 < st["blocking_offload_s"]


def _range_names(run):
    """Every ``torch.profiler.record_function`` name opened while ``run()``."""
    names, real = [], torch.profiler.record_function

    def spy(name, *args, **kw):
        names.append(name)
        return real(name, *args, **kw)
    torch.profiler.record_function = spy
    try:
        run()
    finally:
        torch.profiler.record_function = real
    return names


def _serve(cfg, params, seed):
    eng = _pressed(cfg, params)
    for p in _prompts(seed, 4):
        eng.submit(p, max_new=12)
    eng.run(400)
    assert eng.pool.exec.drain(WAIT_S)
    eng.close()


def test_no_range_without_a_profiler(tiny):
    assert _range_names(lambda: _serve(*tiny, seed=5)) == []


def test_ranges_under_a_profiler(tiny):
    """Under a profiler that follows every thread, the engine's ranges and
    the IO threads' ``kv.offload`` are on the trace, each request's and
    page's id in a range inside its span."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=_ExperimentalConfig(
                                      profile_all_threads=True))
    with prof:
        opened = _range_names(lambda: _serve(*tiny, seed=5))
    assert opened                      # the spans opened their ranges
    evs = prof.events()
    threads = {}
    for e in evs:
        threads.setdefault(e.name, set()).add(e.thread)
    for name in ("serve.decode", "serve.decode.lock", "serve.decode.launch",
                 "serve.prefill", "kv.offload"):
        assert name in threads, name
    assert threads["kv.offload"].isdisjoint(threads["serve.decode"])   # IO threads
    rids = {e.name for e in evs if e.name.startswith("rid=")}
    tags = {e.name for e in evs if e.name.startswith("tag=")}
    assert {f"rid={i}" for i in range(4)} <= rids
    assert tags and all(int(t[4:]) // MAX_PAGES_PER_SEQ < 4 for t in tags)
    # each id range sits inside a span, on the span's thread
    spans = [e for e in evs if e.name.startswith(("serve.", "kv."))]
    for e in evs:
        if e.name.startswith(("rid=", "tag=")):
            assert any(s.thread == e.thread and s.time_range.start <= e.time_range.start
                       and e.time_range.end <= s.time_range.end for s in spans), e.name


def test_queue_waits_of_low_and_high():
    """LOW requests queued behind a held device function wait at least the
    hold; a HIGH request submitted after them issues on the free slot and
    waits less than any of them."""
    release, held, high_done = threading.Event(), threading.Event(), threading.Event()

    def device_fn(dev, payload):
        if payload == "hold":
            held.set()
            assert release.wait(WAIT_S)
        elif payload == "high":
            high_done.set()

    ex = IOExecutor(1, device_fn, max_inflight=2, reserved=1)
    try:
        ex.submit(0, IORequest(payload="hold", priority=LOW))
        assert held.wait(WAIT_S)
        ex.submit(0, IORequest(payload="low1", priority=LOW))
        ex.submit(0, IORequest(payload="low2", priority=LOW))
        queued = time.perf_counter_ns()
        ex.submit(0, IORequest(payload="high", priority=HIGH))
        assert high_done.wait(WAIT_S)
        hold_s = (time.perf_counter_ns() - queued) / 1e9
        release.set()
        assert ex.drain(WAIT_S)
        st = ex.stats(0)
        assert (st.issued_low, st.issued_high) == (3, 1)
        assert st.wait_low_s >= 2 * hold_s
        assert st.wait_low_s > 2 * st.wait_high_s
    finally:
        release.set()
        ex.shutdown()


def test_stale_requests_add_no_wait():
    ex = IOExecutor(1, lambda dev, payload: None, max_inflight=2, reserved=1)
    try:
        gone = threading.Event()
        ex.submit(0, IORequest(payload="x", priority=LOW, is_stale=lambda p: True,
                               on_discard=lambda p: gone.set()))
        assert gone.wait(WAIT_S) and ex.drain(WAIT_S)
        st = ex.stats(0)
        assert (st.discarded_stale, st.issued_low, st.wait_low_s) == (1, 0, 0.0)
    finally:
        ex.shutdown()


class _InsertDuringScan(dict):
    """A host tier whose iteration, after its first key, lets an IO-like
    thread insert a key under the pool's lock, and waits for that insert
    unless the scanning thread holds the lock itself."""

    def __init__(self, pool_lock, *a):
        super().__init__(*a)
        self.pool_lock, self.go, self.inserted = pool_lock, threading.Event(), threading.Event()

    def __iter__(self):
        it = super().__iter__()
        yield next(it)
        self.go.set()
        if not self.pool_lock.locked():
            assert self.inserted.wait(WAIT_S)
        yield from it


def test_free_scans_the_host_tier_under_the_pool_lock(tiny):
    cfg, params = tiny
    eng = _pressed(cfg, params)
    try:
        req = eng.result(eng.submit([1, 2, 3], max_new=2))
        other = MAX_PAGES_PER_SEQ * 7
        tier = _InsertDuringScan(eng.pool._lock, {req.rid * MAX_PAGES_PER_SEQ: (), other: ()})
        eng.pool.host_tier = tier

        def io_insert():
            assert tier.go.wait(WAIT_S)
            with eng.pool._lock:           # as the IO workers insert
                tier[other + 1] = ()
            tier.inserted.set()
        t = threading.Thread(target=io_insert, daemon=True)
        t.start()
        eng._free(req)
        t.join(WAIT_S)
        assert not t.is_alive()
        assert set(tier) == {other, other + 1}
    finally:
        eng.close()
