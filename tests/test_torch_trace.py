"""The port's trace bridge (``repro_torch.serving.{trace_shim,fleet}``,
``repro_torch.core.workloads``) against the JAX package's: the same fleet
config and seed give the same trace array (``trace_digest``), a checkpoint
save recorded through either package's ``CheckpointManager`` gives the same
rows, the recorder's unit cases of ``tests/test_serving_replay.py`` hold for
the port's copy, and a trace the port records replays through the SSD-array
simulator (which stays in the JAX package: numpy on the host) bit-identically,
serial against parallel."""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import workloads as jwl
from repro.core.gc_sim import ArraySim, SSDParams, Workload
from repro.core.qos import QosPolicy, TenantSpec
from repro.core.sharded import ShardedArraySim
from repro.serving import fleet as jfleet
from repro.serving import trace_shim as jshim
from repro_torch.core import workloads as twl
from repro_torch.core.io_queues import HIGH, LOW, IORequest
from repro_torch.serving import fleet as tfleet
from repro_torch.serving import trace_shim as tshim
from repro_torch.serving.kv_pool import PagedKVPool

SMALL = SSDParams(capacity_pages=4096)
# tests/test_serving_replay.py's SMOKE, and the defaults
CONFIGS = {"smoke": dict(n_targets=4, duration_s=0.2, arrival_rate=400.0, pool_sets=8,
                         set_size=8, flush_trigger=1),
           "default": {}}
SEEDS = (0, 11, 12)


def test_trace_constants_match_jax():
    assert (twl.TRACE_READ, twl.TRACE_WRITE, twl.TRACE_VERSION, twl.TRACE_COLUMNS) == \
        (jwl.TRACE_READ, jwl.TRACE_WRITE, jwl.TRACE_VERSION, jwl.TRACE_COLUMNS)
    assert tfleet.PAGES_PER_SESSION_CAP == jfleet.PAGES_PER_SESSION_CAP
    assert tshim.CKPT_TENANT == jshim.CKPT_TENANT


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_fleet_digest_matches_jax(config, seed):
    """``run_fleet`` over the port's pool and recorder emits the trace JAX's
    emits, row for row, with the same fleet and pool counters."""
    port = tfleet.run_fleet(tfleet.FleetConfig(**CONFIGS[config]), seed=seed)
    ref = jfleet.run_fleet(jfleet.FleetConfig(**CONFIGS[config]), seed=seed)
    assert len(port.trace) > 0
    assert tshim.trace_digest(port.trace) == jshim.trace_digest(ref.trace)
    for name in ("tokens_total", "sessions_started", "sessions_completed", "offloads",
                 "fetches", "stale_discards", "dirty_evictions", "alloc_failures"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.meta == ref.meta


def test_attach_ckpt_digest_matches_jax(tmp_path):
    """One f32 tree saved through each package's ``CheckpointManager`` with
    ``attach_ckpt``: one write row a chunk, on the stable key hash's target,
    and the same digest (JAX's restore refuses bf16, so the tree is f32)."""
    jax = pytest.importorskip("jax")
    import torch

    from repro.checkpoint.async_ckpt import CheckpointManager as JaxManager
    from repro_torch.checkpoint import CheckpointManager

    rng = np.random.default_rng(0)
    tree = {"blocks": {"w": rng.normal(size=(4, 8)).astype(np.float32),
                       "b": rng.normal(size=(8,)).astype(np.float32)},
            "embed": rng.normal(size=(16, 4)).astype(np.float32)}
    traces = []
    for mgr_cls, shim, conv, sub in (
            (CheckpointManager, tshim, torch.from_numpy, "port"),
            (JaxManager, jshim, jax.numpy.asarray, "jax")):
        rec = shim.ServingTraceRecorder(4)
        mgr = mgr_cls(tmp_path / sub, n_targets=4)
        rec.attach_ckpt(mgr)
        rec.advance(0.5)
        mgr.save_async(1, {"blocks": {k: conv(v) for k, v in tree["blocks"].items()},
                           "embed": conv(tree["embed"])})
        mgr.barrier()
        assert mgr.wait_for_commit(1)
        tr = rec.to_array()
        mgr.close()
        assert len(tr) == 3
        assert set(tr[:, 2]) == {float(twl.TRACE_WRITE)}
        assert set(tr[:, 3]) == {float(tshim.CKPT_TENANT)}
        assert {int(r[1]) for r in tr} == {tshim.stable_key_lba(k)
                                           for k in ("blocks/w", "blocks/b", "embed")}
        traces.append(tr)
    assert tshim.trace_digest(traces[0]) == jshim.trace_digest(traces[1])


# -- the recorder's unit cases of tests/test_serving_replay.py, on the port ----


def _pool_with_recorder(n_targets=4, tenant_of=None):
    rec = tshim.ServingTraceRecorder(n_targets, tenant_of=tenant_of)
    pool = PagedKVPool(8, 8, n_targets=n_targets, copy_out=lambda tag: (),
                       copy_in=lambda tag, data: None, flush_trigger=0)
    rec.attach_pool(pool)
    return pool, rec


def _case_tenants():
    pool, rec = _pool_with_recorder(tenant_of=lambda tag: tag % 3)
    for tag in (5, 6):
        pool.alloc.alloc(tag)
        pool.alloc.mark_full(tag)
        pool.note_page_full(pool.alloc.set_of(tag))
    rec.advance(1e-3)
    rec.pump()
    assert pool.alloc.stats.offloads == 2
    pool.alloc.free([5])                 # evicted from HBM, then fetched back (HIGH)
    rec.advance(1e-3)
    pool.fetch([5])
    tr = rec.to_array()
    assert tr.shape == (3, 4)
    assert {int(r[1]) for r in tr[tr[:, 2] == twl.TRACE_WRITE]} == {5, 6}
    assert [int(r[1]) for r in tr[tr[:, 2] == twl.TRACE_READ]] == [5]
    for row in tr:
        assert int(row[3]) == int(row[1]) % 3
    assert list(tr[:, 0]) == pytest.approx([1e-3, 1e-3, 2e-3])
    pool.close()


def _case_stale_discards():
    pool, rec = _pool_with_recorder()
    pool.alloc.alloc(9)
    pool.alloc.mark_full(9)
    pool.note_page_full(pool.alloc.set_of(9))
    pool.alloc.free([9])                 # the sequence finished before the flush
    rec.pump()
    assert rec.stale_discards() == 1
    assert pool.alloc.stats.stale_discards == 1
    assert rec.to_array().shape == (0, 4)
    pool.close()


def _case_high_synchronous():
    hits = []
    rec = tshim.ServingTraceRecorder(2)
    ex = rec._make_exec(2, lambda dev, payload: hits.append(dev))
    ex.submit(1, IORequest(payload={"op": "fetch", "tag": 3}, priority=HIGH))
    assert hits == [1]
    ex.submit(0, IORequest(payload={"op": "offload", "tag": 2}, priority=LOW))
    assert hits == [1]                   # LOW waits for an explicit pump
    assert ex.pump() == 1
    assert hits == [1, 0]


def _case_unknown_payload():
    hits = []
    rec = tshim.ServingTraceRecorder(1)
    ex = rec._make_exec(1, lambda dev, payload: hits.append(payload))
    ex.submit(0, IORequest(payload={"op": "mystery"}, priority=HIGH))
    assert hits == [{"op": "mystery"}]
    assert rec.to_array().shape == (0, 4)


def _case_record_direct():
    rec = tshim.ServingTraceRecorder(2)
    rec.advance(0.5)
    rec.record_direct(17, twl.TRACE_WRITE, tenant=4)
    assert rec.to_array().tolist() == [[0.5, 17.0, 1.0, 4.0]]
    assert isinstance(rec.clock, tshim.LogicalClock)
    v = tshim.stable_key_lba("x")
    assert v == jshim.stable_key_lba("x") and 0 <= v < 2 ** 52 and int(float(v)) == v


def _case_round_trip(tmp_path):
    tr = np.array([[0.0, 5, 1, 0], [1.0, 6, 0, 2]], dtype=np.float64)
    p = tmp_path / "t.npz"
    tshim.save_trace(p, tr, meta={"n_targets": 4})
    back, meta = tshim.load_trace(p, with_meta=True)
    np.testing.assert_array_equal(back, tr)
    assert meta == {"n_targets": 4}
    np.testing.assert_array_equal(jshim.load_trace(p), tr)     # JAX reads the port's file
    assert tshim.trace_digest(back) == jshim.trace_digest(tr)


def _case_version_refused(tmp_path):
    p = tmp_path / "t.npz"
    np.savez(p, version=np.int64(99), trace=np.zeros((1, 4)))
    with pytest.raises(ValueError):
        tshim.load_trace(p)


RECORDER_CASES = {"tenants": _case_tenants, "stale_discards": _case_stale_discards,
                  "high_synchronous": _case_high_synchronous,
                  "unknown_payload": _case_unknown_payload,
                  "record_direct": _case_record_direct, "round_trip": _case_round_trip,
                  "version_refused": _case_version_refused}


@pytest.mark.parametrize("case", list(RECORDER_CASES))
def test_recorder_cases(case, tmp_path):
    fn = RECORDER_CASES[case]
    fn(tmp_path) if fn.__code__.co_argcount else fn()


# -- replay through the simulator -------------------------------------------


def test_port_trace_replays_like_jax():
    """A trace the port records replays through ``ShardedArraySim`` with
    the same results serial and parallel, and those equal the replay of
    JAX's trace at the same seed; ``ArraySim`` replays it too."""
    port = tfleet.run_fleet(tfleet.FleetConfig(**CONFIGS["smoke"]), seed=11).trace
    ref = jfleet.run_fleet(jfleet.FleetConfig(**CONFIGS["smoke"]), seed=11).trace
    qos = QosPolicy(tenants=(TenantSpec(0, 2.0, slo_p99=4e-3), TenantSpec(1, 1.0)))
    wl = Workload(scenario="trace", w_total=4 * 8, qd_per_ssd=8, n_streams=4,
                  trace_time_scale=0.05)
    runs = [ShardedArraySim(4, SMALL, 0.6, wl, seed=2, n_shards=2, trace=tr, qos=qos,
                            parallel=par).run(len(tr))
            for tr, par in ((port, False), (port, True), (ref, False))]
    for other in runs[1:]:
        assert other.iops == runs[0].iops
        assert other.p99_latency == runs[0].p99_latency
        np.testing.assert_array_equal(other.per_ssd_iops, runs[0].per_ssd_iops)
        assert {t: (s.ops, s.p99_latency) for t, s in other.tenant_stats.items()} == \
            {t: (s.ops, s.p99_latency) for t, s in runs[0].tenant_stats.items()}
    single = ArraySim(4, SMALL, 0.6, wl, seed=2, trace=port, qos=qos).run(len(port))
    assert sum(s.ops for s in single.tenant_stats.values()) == len(port)
