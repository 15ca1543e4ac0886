"""Dirty-page flusher (paper §3.3): trigger / FIFO round-robin / per-visit budget.

The flusher is deliberately split from any cache implementation: it talks to a
``CacheView`` protocol so the same policy object drives (a) the numpy SA-cache
in the SAFS simulator, (b) the dirty-chunk tracker of the async checkpointer,
and (c) the JAX paged-KV pool (via host-side mirrors of the device state).

Paper parameters: page sets of 12, trigger at 6 dirty pages, 1-2 flushes per
set visit, a FIFO of triggered sets visited round-robin, and a global cap of
2048 pending flush requests per device.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Protocol

from .policies import FLUSHES_PER_VISIT, FLUSH_TRIGGER, MAX_PENDING_FLUSH_PER_DEV


class CacheView(Protocol):
    """What the flusher needs to know about a cache."""

    def dirty_count(self, set_idx: int) -> int: ...

    def flush_candidates(self, set_idx: int) -> list[tuple[int, int, int]]:
        """Dirty (slot, tag, flush_score) triples, highest score first."""

    def device_of(self, tag: int) -> int:
        """Which device the page belongs to (for per-device pending caps)."""

    # Optional: caches that version their dirty bits also expose
    #   dirty_epoch_of(set_idx, slot) -> int
    # (see NumpySACache); the flusher stamps it into FlushRequest.dirty_epoch.


@dataclass(frozen=True)
class FlushRequest:
    """A queued low-priority writeback. ``score_at_issue`` is recorded so the
    staleness check (§3.3.2 rule iii) can compare against the *current* score.
    ``dirty_epoch`` captures the slot's dirty version at issue time: the
    completion may clean the slot only while the epoch is unchanged, so a
    write that re-dirties the slot after the flush was issued is never lost."""

    tag: int
    set_idx: int
    slot: int
    device: int
    score_at_issue: int
    dirty_epoch: int = 0


@dataclass
class DirtyPageFlusher:
    cache: CacheView
    n_devices: int
    trigger: int = FLUSH_TRIGGER
    per_visit: int = FLUSHES_PER_VISIT
    max_pending_per_dev: int = MAX_PENDING_FLUSH_PER_DEV
    # FIFO of set indices that crossed the trigger (paper: "placed in a FIFO
    # queue ... checks the page sets in the queue in a round-robin manner").
    _fifo: deque = field(default_factory=deque)
    _queued_sets: set = field(default_factory=set)
    _pending_per_dev: dict = field(default_factory=dict)
    # pages already in flight so we never double-flush the same (set, slot, tag)
    _inflight: set = field(default_factory=set)
    _total_pending: int = 0
    issued: int = 0
    # Optional fault hook (core/faults.py): ``deferrable(device) -> True``
    # defers that device's writebacks — the pages simply STAY DIRTY and their
    # sets stay queued for a later pump, so a crashed or quarantined member's
    # writebacks are delayed, never lost. ``deferred`` counts the skips.
    deferrable: "Callable[[int], bool] | None" = None
    deferred: int = 0
    # IOExecutor workers call note_flush_done/discarded concurrently (one
    # thread pool per device); the counters are read-modify-write. Reentrant:
    # note_flush_discarded delegates to note_flush_done. Uncontended in the
    # single-threaded simulators.
    _mu: threading.RLock = field(default_factory=threading.RLock)

    def saturated(self, frac: float = 0.95) -> bool:
        """Cheap gate: skip pumping when the global pending pool is ~full."""
        return self._total_pending >= frac * self.n_devices * self.max_pending_per_dev

    # -- cache-side notifications ------------------------------------------
    def note_write(self, set_idx: int) -> None:
        """Called after a page in ``set_idx`` becomes dirty."""
        with self._mu:
            if set_idx not in self._queued_sets and self.cache.dirty_count(set_idx) > self.trigger:
                self._queued_sets.add(set_idx)
                self._fifo.append(set_idx)

    # -- executor-side notifications ---------------------------------------
    def note_flush_done(self, req: FlushRequest) -> None:
        with self._mu:
            self._pending_per_dev[req.device] = self._pending_per_dev.get(req.device, 0) - 1
            self._total_pending -= 1
            self._inflight.discard((req.set_idx, req.slot, req.tag))

    def note_flush_discarded(self, req: FlushRequest) -> None:
        self.note_flush_done(req)

    def pending(self, device: int | None = None) -> int:
        with self._mu:
            if device is not None:
                return self._pending_per_dev.get(device, 0)
            return sum(self._pending_per_dev.values())

    # -- request generation --------------------------------------------------
    def make_requests(self, budget: int | None = None,
                      max_visits: int | None = None) -> list[FlushRequest]:
        """Round-robin over triggered sets, ``per_visit`` pages per visit,
        until queues drain or per-device pending caps are hit.

        ``max_visits`` bounds work per call: when device caps are saturated a
        full FIFO walk would be O(#sets) for nothing — visited sets keep their
        FIFO position and are retried on the next pump instead.
        """
        with self._mu:
            return self._make_requests_locked(budget, max_visits)

    def _make_requests_locked(self, budget, max_visits) -> list[FlushRequest]:
        out: list[FlushRequest] = []
        stalled: list[int] = []  # sets skipped only due to device caps
        epoch_of = getattr(self.cache, "dirty_epoch_of", None)
        if budget is None:
            budget = 1 << 30
        if max_visits is None:
            max_visits = max(32, 4 * budget)
        rounds = 0
        while self._fifo and len(out) < budget:
            rounds += 1
            if rounds > max_visits:
                break  # bounded pump; remaining sets stay queued
            set_idx = self._fifo.popleft()
            cands = [
                (slot, tag, score)
                for slot, tag, score in self.cache.flush_candidates(set_idx)
                if (set_idx, slot, tag) not in self._inflight
            ]
            if not cands:
                self._queued_sets.discard(set_idx)
                continue
            took = 0
            capped = False
            for slot, tag, score in cands:
                if took >= self.per_visit or len(out) >= budget:
                    break
                dev = self.cache.device_of(tag)
                if self.deferrable is not None and self.deferrable(dev):
                    # crashed/quarantined device: leave the page dirty and
                    # the set queued (same retry path as a full device cap)
                    self.deferred += 1
                    capped = True
                    continue
                if self._pending_per_dev.get(dev, 0) >= self.max_pending_per_dev:
                    capped = True
                    continue
                self._pending_per_dev[dev] = self._pending_per_dev.get(dev, 0) + 1
                self._total_pending += 1
                self._inflight.add((set_idx, slot, tag))
                out.append(FlushRequest(
                    tag=tag, set_idx=set_idx, slot=slot, device=dev,
                    score_at_issue=score,
                    dirty_epoch=epoch_of(set_idx, slot) if epoch_of else 0))
                took += 1
            if len(cands) > took:
                # still has flushable pages: keep in FIFO (re-append = round robin)
                if capped and took == 0:
                    stalled.append(set_idx)
                else:
                    self._fifo.append(set_idx)
            else:
                self._queued_sets.discard(set_idx)
        for s in stalled:  # retry capped sets on the next call
            self._fifo.append(s)
        self.issued += len(out)
        return out


@dataclass
class StalenessChecker:
    """Paper §3.3.2 — evaluated at the moment a flush request reaches the head
    of the low-priority queue, NOT at enqueue time."""

    is_evicted: Callable[[FlushRequest], bool]
    is_clean: Callable[[FlushRequest], bool]
    current_score: Callable[[FlushRequest], int]
    score_threshold: int = 0

    def __call__(self, req: FlushRequest) -> bool:
        if self.is_evicted(req):
            return True
        if self.is_clean(req):
            return True
        return self.current_score(req) < self.score_threshold
