"""Dual-priority per-device I/O queues (paper §3.2) + a threaded host executor.

Two layers:

* ``next_action`` / ``DualQueue`` — the pure scheduling policy (short
  high-priority queue, long low-priority queue, reserved device slots for
  high-priority requests, stale-discard at dequeue). Shared by the
  discrete-event simulator and the real executor so both are testable against
  the same invariants.
* ``IOExecutor`` — a real thread-per-device runtime used by the async
  checkpointer: device == a storage target (one shard file / one host NIC
  stream). This is the SAFS "dedicated I/O thread per SSD" design.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .policies import DEVICE_SLOTS, RESERVED_SLOTS

HIGH = 0
LOW = 1


def next_action(
    high_len: int,
    low_len: int,
    inflight_high: int,
    inflight_low: int,
    max_inflight: int = DEVICE_SLOTS,
    reserved: int = RESERVED_SLOTS,
) -> Optional[int]:
    """Which queue may issue next, or None.

    Rules (paper §3.2):
      * high-priority requests issue whenever any device slot is free;
      * low-priority requests issue only when (a) no high-priority request is
        waiting and (b) at least ``reserved`` slots would remain free for
        future high-priority arrivals.
    """
    inflight = inflight_high + inflight_low
    if high_len > 0 and inflight < max_inflight:
        return HIGH
    if low_len > 0 and high_len == 0 and inflight < max_inflight - reserved:
        return LOW
    return None


@dataclass
class IOStats:
    issued_high: int = 0
    issued_low: int = 0
    discarded_stale: int = 0
    completed: int = 0


@dataclass
class IORequest:
    payload: Any
    priority: int = LOW
    # evaluated when the request reaches the queue head (§3.3.2)
    is_stale: Optional[Callable[[Any], bool]] = None
    on_complete: Optional[Callable[[Any], None]] = None
    on_discard: Optional[Callable[[Any], None]] = None
    # tenant class for QoS-aware queues (core/qos.py TenantDualQueue);
    # ignored by the plain DualQueue discipline
    tenant: int = 0


@dataclass
class DualQueue:
    """Non-thread-safe dual queue + slot accounting (simulator building block)."""

    max_inflight: int = DEVICE_SLOTS
    reserved: int = RESERVED_SLOTS
    high_capacity: int = 4 * DEVICE_SLOTS
    low_capacity: int = 1 << 20
    high: deque = field(default_factory=deque)
    low: deque = field(default_factory=deque)
    inflight_high: int = 0
    inflight_low: int = 0
    stats: IOStats = field(default_factory=IOStats)
    # executor asks the flusher for more work after discarding stale requests
    refill: Optional[Callable[[], None]] = None

    def submit(self, req: IORequest) -> bool:
        q, cap = (self.high, self.high_capacity) if req.priority == HIGH else (self.low, self.low_capacity)
        if len(q) >= cap:
            return False
        q.append(req)
        return True

    def pop_next(self) -> Optional[IORequest]:
        """Apply the policy; drops stale low-priority heads (counts them)."""
        discarded = False
        while True:
            act = next_action(len(self.high), len(self.low), self.inflight_high,
                              self.inflight_low, self.max_inflight, self.reserved)
            if act is None:
                break
            if act == HIGH:
                req = self.high.popleft()
                self.inflight_high += 1
                self.stats.issued_high += 1
            else:
                req = self.low.popleft()
                if req.is_stale is not None and req.is_stale(req.payload):
                    self.stats.discarded_stale += 1
                    discarded = True
                    if req.on_discard:
                        req.on_discard(req.payload)
                    continue
                self.inflight_low += 1
                self.stats.issued_low += 1
            if discarded and self.refill:
                self.refill()
            return req
        if discarded and self.refill:
            # "Once discarding stale flush requests, an I/O thread will notify
            # the page cache and ask for more flush requests."
            self.refill()
        return None

    def complete(self, req: IORequest) -> None:
        if req.priority == HIGH:
            self.inflight_high -= 1
        else:
            self.inflight_low -= 1
        self.stats.completed += 1
        if req.on_complete:
            req.on_complete(req.payload)


class IOExecutor:
    """Thread-per-device executor (SAFS's dedicated I/O threads).

    ``device_fn(device_id, payload)`` performs the actual I/O synchronously in
    the worker; parallelism within a device comes from ``max_inflight`` worker
    threads per device. High-priority work preempts queued low-priority work
    (not in-flight work, matching SAFS).
    """

    def __init__(self, n_devices: int, device_fn: Callable[[int, Any], None],
                 max_inflight: int = 8, reserved: int = 2):
        self._device_fn = device_fn
        self._queues = [DualQueue(max_inflight=max_inflight, reserved=reserved)
                        for _ in range(n_devices)]
        self._locks = [threading.Lock() for _ in range(n_devices)]
        self._cvs = [threading.Condition(lock) for lock in self._locks]
        self._refill_fns: dict[int, Callable[[], None]] = {}
        self._refill_pending = [False] * n_devices
        # completion callbacks run outside the device lock; drain() must not
        # report quiescence while one is still pending
        self._cb_outstanding = [0] * n_devices
        self._stop = False
        self._threads = []
        for dev in range(n_devices):
            for slot in range(max_inflight):
                t = threading.Thread(target=self._worker, args=(dev,),
                                     name=f"io-dev{dev}-slot{slot}", daemon=True)
                t.start()
                self._threads.append(t)

    def submit(self, device: int, req: IORequest) -> bool:
        with self._cvs[device]:
            ok = self._queues[device].submit(req)
            if ok:
                self._cvs[device].notify()
            return ok

    def set_refill(self, device: int, fn: Callable[[], None]) -> None:
        """Register the refill callback (the flusher's "give me more work").

        ``DualQueue.pop_next`` fires ``refill`` inline, but workers call
        ``pop_next`` while holding the device condition lock — a callback
        that re-enters ``submit`` on the same device would self-deadlock on
        the non-reentrant lock. So the queue only *records* the request here
        and the worker invokes ``fn`` after releasing the lock."""
        self._refill_fns[device] = fn
        q = self._queues[device]

        def mark(dev: int = device) -> None:   # runs under the device lock
            self._refill_pending[dev] = True
        q.refill = mark

    def stats(self, device: int) -> IOStats:
        return self._queues[device].stats

    def drain(self, timeout: float = 60.0) -> bool:
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with_work = False
            for dev, q in enumerate(self._queues):
                with self._locks[dev]:
                    if (q.high or q.low or q.inflight_high or q.inflight_low
                            or self._cb_outstanding[dev]):
                        with_work = True
                        break
            if not with_work:
                return True
            time.sleep(0.005)
        return False

    def shutdown(self) -> None:
        self._stop = True
        for cv in self._cvs:
            with cv:
                cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)

    def _run_pending_refill(self, dev: int, run_refill: bool) -> None:
        if run_refill:
            fn = self._refill_fns.get(dev)
            if fn is not None:
                fn()

    def _worker(self, dev: int) -> None:
        q, cv = self._queues[dev], self._cvs[dev]
        while True:
            run_refill = False
            with cv:
                req = q.pop_next()
                if self._refill_pending[dev]:
                    self._refill_pending[dev] = False
                    run_refill = True
                if req is None and not run_refill and not self._stop:
                    cv.wait(timeout=0.2)
            # deferred refill: outside the lock, so it may submit() freely
            self._run_pending_refill(dev, run_refill)
            if req is None:
                if self._stop:
                    return
                continue
            # completion callback also runs outside the lock (it may submit
            # follow-on work to this same device); the outstanding count is
            # raised in the same critical section that retires the request so
            # drain() never sees a gap between the two
            cb, req.on_complete = req.on_complete, None
            try:
                self._device_fn(dev, req.payload)
            finally:
                with cv:
                    q.complete(req)
                    if cb is not None:
                        self._cb_outstanding[dev] += 1
                    cv.notify_all()
            if cb is not None:
                try:
                    cb(req.payload)
                finally:
                    with cv:
                        self._cb_outstanding[dev] -= 1
                        cv.notify_all()
