"""Trace-emitting shim: the serving stack's page IO becomes a replayable
workload for the SSD-array simulator. A copy of
``repro/serving/trace_shim.py`` for the PyTorch port, which imports nothing
of ``repro``: it runs over the port's ``core/io_queues.py`` and
``core/workloads.py`` (the trace constants), and attaches to the port's
``PagedKVPool`` and ``CheckpointManager``, which have the attributes it
swaps (``exec``, ``_do_io``; ``_exec``, ``n_targets``, ``_target_of``).

``ServingTraceRecorder`` instruments the two host-side producers of page
traffic — ``PagedKVPool`` (KV offload / fetch / stale-discard) and
``CheckpointManager.save_async`` (checkpoint chunk writes) — by swapping
their threaded ``IOExecutor`` for a deterministic, synchronously-pumped
``RecordingExecutor``. Every IO that actually reaches a device is recorded
as one page-granular ``(time, lba, op, tenant)`` row; stale flush requests
discarded at the queue head (core/io_queues.py dual-queue discipline) never
reach a device and are therefore counted but NOT emitted — exactly the op
stream an SSD array would have seen. Time comes from an explicit
``LogicalClock`` the caller advances (no wall clock, no threads), so the
same workload seed yields a byte-identical trace array on every run.

Device alignment: the pool places tag ``t`` on device ``t % n_targets``
and the recorder emits ``lba = tag`` verbatim, while ``ArraySim``'s JBOD
fast loop maps a (folded) LBA to device ``lba % n_ssds``. Replaying with
``n_ssds == n_targets`` therefore lands every recorded op on the device
that served it (``n_live`` is always a multiple of the member count, so
the fold preserves ``lba % n``). Checkpoint chunks use a stable 64-bit
key hash for both placement and LBA; the shim pins the manager's salted
``hash()``-based ``_target_of`` to the same stable hash so placement —
and with it the emitted trace — is reproducible across processes.

Worked emit -> replay round trip::

    rec = ServingTraceRecorder(n_targets=8, tenant_of=lambda tag: tag % 2)
    rec.attach_pool(pool)                  # swap in the recorder
    ... drive the pool; rec.advance(dt); rec.pump() ...
    save_trace("kv.npz", rec.to_array(), meta={"n_targets": 8})

    trace = load_trace("kv.npz")
    r = ShardedArraySim(8, ssd, 0.6, Workload(scenario="trace"),
                        trace=trace, qos=policy).run(50000)

Trace format (``.npz``, version ``workloads.TRACE_VERSION``): arrays
``trace`` (float64, shape (n, 4), columns ``workloads.TRACE_COLUMNS``),
``version``, ``columns``, and a ``meta`` JSON string for free-form
recording metadata. The byte-identity contract is defined on the trace
ARRAY (``trace_digest``), not the container file (zip timestamps are not
content).

This module imports no torch: anything touching ``checkpoint.async_ckpt``
happens through duck typing on an already-constructed manager object.
"""
from __future__ import annotations

import hashlib
import json
from typing import Callable, Optional

import numpy as np

from repro_torch.core.io_queues import HIGH, DualQueue, IORequest
from repro_torch.core.workloads import (TRACE_COLUMNS, TRACE_READ, TRACE_VERSION,
                                  TRACE_WRITE)

__all__ = ["LogicalClock", "RecordingExecutor", "ServingTraceRecorder",
           "stable_key_lba", "save_trace", "load_trace", "trace_digest",
           "CKPT_TENANT"]

# default tenant id for checkpoint chunk writes: distinct from KV tenants so
# per-tenant SLO accounting separates checkpoint background traffic
CKPT_TENANT = 2


def stable_key_lba(key: str) -> int:
    """Stable page address for a checkpoint chunk key. Python's ``hash(str)``
    is salted per process; this one is reproducible across processes and
    platforms (blake2b), which the emit-twice byte-identity contract
    requires. Clamped to 52 bits: the trace's lba column is float64, and a
    wider hash would lose its LOW bits — exactly the ones that pick the
    device (``lba % n_targets``)."""
    digest = hashlib.blake2b(str(key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") & 0xFFFFFFFFFFFFF


class LogicalClock:
    """Caller-driven simulation clock for trace emission (no wall time)."""

    __slots__ = ("now",)

    def __init__(self) -> None:
        self.now = 0.0

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now


class RecordingExecutor:
    """Deterministic drop-in for ``core.io_queues.IOExecutor``.

    Same surface the serving stack uses (``submit``/``drain``/``shutdown``/
    ``stats``/``set_refill``/``_queues``), but no worker threads:

    * HIGH-priority requests (KV fetches, checkpoint restores) execute
      synchronously inside ``submit`` — the callers block on a semaphore
      released by ``device_fn``, so a deferred HIGH would deadlock them.
    * LOW-priority requests queue on real per-device ``DualQueue``s and are
      served by explicit ``pump(per_device)`` calls from the caller, so a
      backlog can build up and stale flush requests are discarded at the
      head by the genuine dual-queue discipline (discards are counted,
      never recorded — they never reach a device).

    Each executed request is mapped to a trace row via the payload's
    ``op`` field (offload/write -> ``TRACE_WRITE``, fetch/read ->
    ``TRACE_READ``); unknown payloads execute but record nothing."""

    def __init__(self, n_devices: int, device_fn: Callable[[int, object], None],
                 clock: LogicalClock, rows: list,
                 tenant_of: Optional[Callable[[int], int]] = None,
                 ckpt_tenant: int = CKPT_TENANT,
                 max_inflight: int = 2, reserved: int = 1) -> None:
        self._device_fn = device_fn
        self._clock = clock
        self._rows = rows
        self._tenant_of = tenant_of or (lambda tag: 0)
        self._ckpt_tenant = ckpt_tenant
        self._queues = [DualQueue(max_inflight=max_inflight,
                                  reserved=reserved)
                        for _ in range(n_devices)]

    # -- IOExecutor surface -------------------------------------------------
    def submit(self, device: int, req: IORequest) -> bool:
        if req.priority == HIGH:
            self._record(req)
            self._device_fn(device, req.payload)
            if req.on_complete:
                req.on_complete(req.payload)
            return True
        return self._queues[device].submit(req)

    def set_refill(self, device: int, fn: Callable[[], None]) -> None:
        self._queues[device].refill = fn

    def stats(self, device: int):
        return self._queues[device].stats

    def drain(self, timeout: float = 60.0) -> bool:
        while self.pump() > 0:
            pass
        return True

    def shutdown(self) -> None:
        pass

    # -- deterministic service ---------------------------------------------
    def pump(self, per_device: int = 4) -> int:
        """Serve up to ``per_device`` queued LOW requests on every device
        (round-robin by device id — one fixed, documented order). Returns
        the number of requests actually executed."""
        served = 0
        for dev, q in enumerate(self._queues):
            for _ in range(per_device):
                req = q.pop_next()
                if req is None:
                    break
                self._record(req)
                self._device_fn(dev, req.payload)
                q.complete(req)
                served += 1
        return served

    def backlog(self) -> int:
        return sum(len(q.high) + len(q.low) for q in self._queues)

    def stale_discards(self) -> int:
        return sum(q.stats.discarded_stale for q in self._queues)

    def _record(self, req: IORequest) -> None:
        p = req.payload
        if not isinstance(p, dict):
            return
        op = p.get("op")
        if op == "offload":
            row = (float(p["tag"]), TRACE_WRITE, self._tenant_of(p["tag"]))
        elif op == "fetch":
            row = (float(p["tag"]), TRACE_READ, self._tenant_of(p["tag"]))
        elif op == "write":
            row = (float(stable_key_lba(p["key"])), TRACE_WRITE,
                   self._ckpt_tenant)
        elif op == "read":
            row = (float(stable_key_lba(p["key"])), TRACE_READ,
                   self._ckpt_tenant)
        else:
            return
        self._rows.append((self._clock.now,) + row)


class ServingTraceRecorder:
    """Facade tying the clock, the rows, and the attached executors together.

    ``attach_pool``/``attach_ckpt`` swap the target's threaded executor for
    a shared-clock ``RecordingExecutor`` (the displaced executor is shut
    down). The caller then interleaves workload steps with ``advance(dt)``
    and ``pump()`` calls; ``to_array()`` yields the (n, 4) float64 trace,
    time-ordered by construction."""

    def __init__(self, n_targets: int,
                 tenant_of: Optional[Callable[[int], int]] = None,
                 ckpt_tenant: int = CKPT_TENANT) -> None:
        self.n_targets = n_targets
        self.clock = LogicalClock()
        self.rows: list = []
        self._tenant_of = tenant_of
        self._ckpt_tenant = ckpt_tenant
        self._execs: list[RecordingExecutor] = []

    def _make_exec(self, n_devices: int, device_fn) -> RecordingExecutor:
        ex = RecordingExecutor(n_devices, device_fn, self.clock, self.rows,
                               tenant_of=self._tenant_of,
                               ckpt_tenant=self._ckpt_tenant)
        self._execs.append(ex)
        return ex

    def attach_pool(self, pool) -> "ServingTraceRecorder":
        """Instrument a ``PagedKVPool``: its offloads/fetches are recorded,
        its stale discards counted. Attach right after construction, before
        any IO is submitted."""
        old = pool.exec
        pool.exec = self._make_exec(len(old._queues), pool._do_io)
        old.shutdown()
        return self

    def attach_ckpt(self, mgr) -> "ServingTraceRecorder":
        """Instrument a ``CheckpointManager``: chunk writes/reads are
        recorded under the checkpoint tenant. Also pins the manager's
        process-salted ``hash()`` placement to the stable key hash so the
        emitted trace is reproducible across processes (placement and
        recorded LBA then agree: ``lba % n_targets == target``)."""
        old = mgr._exec
        mgr._exec = self._make_exec(mgr.n_targets, mgr._do_io)
        mgr._target_of = lambda key: stable_key_lba(key) % mgr.n_targets
        old.shutdown()
        return self

    # -- caller hooks -------------------------------------------------------
    def advance(self, dt: float) -> float:
        return self.clock.advance(dt)

    def record_direct(self, lba: int, op: int, tenant: int = 0) -> None:
        """Record an IO that bypasses the executor — the pool's synchronous
        spill paths (``offload_now``/``offload_now_evicted``: blocking
        dirty-eviction offloads) still hit the spill device and belong in
        the trace; the caller calls this right after invoking them."""
        self.rows.append((self.clock.now, float(lba), float(op),
                          float(tenant)))

    def pump(self, per_device: int = 4) -> int:
        return sum(ex.pump(per_device) for ex in self._execs)

    def drain(self) -> None:
        for ex in self._execs:
            ex.drain()

    # -- results ------------------------------------------------------------
    def to_array(self) -> np.ndarray:
        if not self.rows:
            return np.empty((0, 4), dtype=np.float64)
        return np.asarray(self.rows, dtype=np.float64)

    def stale_discards(self) -> int:
        return sum(ex.stale_discards() for ex in self._execs)

    def backlog(self) -> int:
        return sum(ex.backlog() for ex in self._execs)


# -- trace container --------------------------------------------------------

def trace_digest(trace: np.ndarray) -> str:
    """SHA-256 over shape + row bytes: the byte-identity contract is on
    this canonical array form (same seed => same digest)."""
    arr = np.ascontiguousarray(np.asarray(trace, dtype=np.float64))
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def save_trace(path, trace: np.ndarray, meta: dict | None = None) -> None:
    """Write the versioned ``.npz`` trace container."""
    arr = np.asarray(trace, dtype=np.float64)
    assert arr.ndim == 2 and arr.shape[1] in (3, 4), "bad trace shape"
    np.savez_compressed(
        path,
        version=np.int64(TRACE_VERSION),
        columns=np.array(TRACE_COLUMNS[:arr.shape[1]]),
        trace=arr,
        meta=np.array(json.dumps(meta or {})),
    )


def load_trace(path, with_meta: bool = False):
    """Load a trace container; returns the (n, 3|4) array (and the meta
    dict when ``with_meta``). Rejects unknown future versions."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["version"])
        if version > TRACE_VERSION:
            raise ValueError(f"trace version {version} is newer than "
                             f"supported ({TRACE_VERSION})")
        trace = z["trace"]
        meta = json.loads(str(z["meta"])) if "meta" in z else {}
    return (trace, meta) if with_meta else trace
