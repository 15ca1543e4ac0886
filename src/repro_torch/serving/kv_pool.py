"""Paged KV pool with set-associative placement + the paper's policies.

HBM pool pages are grouped into page SETS (SA-cache, paper §3.1): a page for
tag = (seq, page_idx) may live only in set ``hash(tag) % num_sets``, so every
policy decision is a 12-wide vector op, never a global scan. On top of it:

  * pinned   — pages of ACTIVE sequences (attention needs residency);
  * dirty    — device-only content (no host-tier copy yet);
  * clean    — a host-tier copy exists (offloaded by the flusher).

The dirty-page flusher (core/flusher.py, unchanged) pre-cleans FULL pages of
active sequences in the background over per-target dual-priority queues, so
a preemption or eviction almost always hits a *clean* page and costs nothing
— the paper's thesis transplanted: convert blocking evictions into
background bandwidth. Queued offloads whose page was freed (sequence
finished) are discarded stale at the queue head (§3.3.2).

GClock hits are bumped every time a page is read by decode (recency), and
eviction inside a set is clean-first analytic GClock — identical math to
``core/policies.py`` (property-tested).

A copy of ``repro/serving/kv_pool.py`` for the PyTorch port (the port
imports nothing of ``repro``); ``tests/test_torch_serving.py`` holds the two
allocators to the same decisions.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.core import policies
from repro_torch.core.flusher import DirtyPageFlusher, FlushRequest, StalenessChecker
from repro_torch.core.io_queues import HIGH, LOW, IOExecutor, IORequest
from .spans import Spans


def _mix64(x: int) -> int:
    """splitmix64 finalizer — cheap stateless permutation-ish hash."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


@dataclass
class PoolStats:
    clean_evictions: int = 0
    dirty_evictions: int = 0          # blocking offload on the alloc path
    alloc_failures: int = 0           # -> engine preempts a sequence
    offloads: int = 0
    fetches: int = 0
    stale_discards: int = 0


class PagedAllocator:
    """Host control plane for the HBM page pool (numpy, O(set_size) ops)."""

    def __init__(self, num_sets: int, set_size: int = policies.SET_SIZE):
        self.num_sets, self.set_size = num_sets, set_size
        n = num_sets * set_size
        self.tags = np.full(n, -1, dtype=np.int64)
        self.hits = np.zeros(n, dtype=np.int32)
        self.dirty = np.zeros(n, dtype=bool)
        self.pinned = np.zeros(n, dtype=bool)
        self.full = np.zeros(n, dtype=bool)      # page completely written
        self.clock = np.zeros(num_sets, dtype=np.int32)
        self.where: dict[int, int] = {}          # tag -> page_id
        self.stats = PoolStats()

    # -- helpers -------------------------------------------------------------
    def set_of(self, tag: int) -> int:
        return _mix64(tag * 2 + 1) % self.num_sets

    def set2_of(self, tag: int) -> int:
        """Second placement choice (d=2). Pure SA placement cannot guarantee
        CO-RESIDENCY of one sequence's pinned pages (3 pinned tags hashing to
        a 2-way set would deadlock an admission forever); two choices plus
        the bounded spill below make that probability negligible while the
        policy math stays per-set."""
        return _mix64(tag * 2 + 7) % self.num_sets

    def _slots(self, s: int) -> slice:
        return slice(s * self.set_size, (s + 1) * self.set_size)

    def page_id(self, tag: int) -> Optional[int]:
        return self.where.get(tag)

    def _try_set(self, s: int) -> Optional[int]:
        """Find a slot in set ``s``: empty, else clean-first GClock among
        UNPINNED (eligibility-masked analytic sweep). None if fully pinned."""
        sl = self._slots(s)
        tags = self.tags[sl]
        empty = np.flatnonzero(tags == -1)
        if empty.size:
            return s * self.set_size + int(empty[0])
        eligible = ~self.pinned[sl]
        if not eligible.any():
            return None
        clean = eligible & ~self.dirty[sl]
        cand = clean if clean.any() else eligible
        ss = self.set_size
        hits = self.hits[sl]
        dist = (np.arange(ss) - self.clock[s]) % ss
        score = np.where(cand, hits * ss + dist, np.iinfo(np.int64).max)
        slot = int(np.argmin(score))
        # sweep decrement bookkeeping (mirrors policies gclock semantics)
        h_v = int(hits[slot])
        visits = np.where(dist < dist[slot], h_v + 1, h_v)
        hits = np.maximum(hits - np.where(cand, visits, 0), 0)
        hits[slot] = 0
        self.hits[sl] = hits
        self.clock[s] = (slot + 1) % ss
        return s * self.set_size + slot

    # -- allocation (paper: clean-first GClock within the set) ---------------
    def alloc(self, tag: int) -> tuple[Optional[int], Optional[int], bool]:
        """Allocate a page for ``tag``.

        Returns (page_id, evicted_tag, evicted_dirty). page_id None => every
        candidate slot is pinned: the engine must preempt a sequence and
        retry. ``evicted_dirty`` True means the caller owes a blocking
        offload of the victim before reusing the slot (the stall the flusher
        makes rare)."""
        page = None
        s1 = self.set_of(tag)
        s2 = self.set2_of(tag)
        for s in (s1,) if s1 == s2 else (s1, s2):
            page = self._try_set(s)
            if page is not None:
                break
        if page is None:
            # bounded spill: co-residency escape hatch (placement is a
            # heuristic — `where` maps tags to pages directly)
            free = np.flatnonzero((self.tags == -1))
            if free.size:
                page = int(free[0])
            else:
                evictable = ~self.pinned & (self.tags != -1)
                clean = evictable & ~self.dirty
                cand = clean if clean.any() else evictable
                if cand.any():
                    page = int(np.flatnonzero(cand)[0])
        if page is None:
            self.stats.alloc_failures += 1
            return None, None, False
        evicted_tag = int(self.tags[page]) if self.tags[page] != -1 else None
        evicted_dirty = bool(self.dirty[page]) if evicted_tag is not None else False
        if evicted_tag is not None:
            del self.where[evicted_tag]
            if evicted_dirty:
                self.stats.dirty_evictions += 1
            else:
                self.stats.clean_evictions += 1
        self.tags[page] = tag
        self.hits[page] = 0
        self.dirty[page] = True
        self.full[page] = False
        self.pinned[page] = True
        self.where[tag] = page
        return page, evicted_tag, evicted_dirty

    # -- state transitions ----------------------------------------------------
    def touch(self, tags: list[int]) -> None:
        for t in tags:
            p = self.where.get(t)
            if p is not None:
                self.hits[p] = min(self.hits[p] + 1, 15)

    def mark_full(self, tag: int) -> None:
        p = self.where.get(tag)
        if p is not None:
            self.full[p] = True

    def mark_clean(self, tag: int) -> None:
        p = self.where.get(tag)
        if p is not None:
            self.dirty[p] = False

    def set_pinned(self, tags: list[int], value: bool) -> None:
        for t in tags:
            p = self.where.get(t)
            if p is not None:
                self.pinned[p] = value

    def free(self, tags: list[int]) -> None:
        for t in tags:
            p = self.where.pop(t, None)
            if p is not None:
                self.tags[p] = -1
                self.dirty[p] = False
                self.pinned[p] = False
                self.full[p] = False
                self.hits[p] = 0

    # -- CacheView protocol for the flusher (full dirty pages only) ----------
    def dirty_count(self, set_idx: int) -> int:
        sl = self._slots(set_idx)
        return int((self.dirty[sl] & self.full[sl] & (self.tags[sl] != -1)).sum())

    def flush_candidates(self, set_idx: int):
        sl = self._slots(set_idx)
        tags = self.tags[sl]
        flushable = self.dirty[sl] & self.full[sl] & (tags != -1)
        if not flushable.any():
            return []
        fs = policies.flush_scores(self.hits[sl], int(self.clock[set_idx]),
                                   valid=(tags != -1))
        out = [(int(i), int(tags[i]), int(fs[i]))
               for i in np.flatnonzero(flushable)]
        out.sort(key=lambda t: -t[2])
        return out

    def device_of(self, tag: int) -> int:
        return tag % max(getattr(self, "n_targets", 1), 1)

    def flush_score_of(self, set_idx: int, slot: int) -> int:
        sl = self._slots(set_idx)
        fs = policies.flush_scores(self.hits[sl], int(self.clock[set_idx]),
                                   valid=(self.tags[sl] != -1))
        return int(fs[slot])


class PagedKVPool:
    """Device pool + host tier + flusher + offload executor.

    The device tensors live in ``engine``;
    this class owns placement (allocator), the host tier (the "SSD"), and the
    background offload pipeline. ``copy_out(tag) -> host tensors`` and
    ``copy_in(tag, arrays)`` are provided by the engine, and so is ``spans``
    (the engine's ``Spans``; without one the pool makes its own), in which
    each background copy-out on an IO thread is a ``kv.offload`` span.
    """

    def __init__(self, num_sets: int, set_size: int, *, n_targets: int = 2,
                 copy_out: Callable, copy_in: Callable,
                 flush_trigger: int = policies.FLUSH_TRIGGER,
                 max_pending_per_target: int = 64,
                 offload_delay: float = 0.0, spans: Optional[Spans] = None):
        self.alloc = PagedAllocator(num_sets, set_size)
        self.alloc.n_targets = n_targets
        self.host_tier: dict[int, tuple] = {}
        self._copy_out = copy_out
        self._copy_in = copy_in
        self._offload_delay = offload_delay
        self.spans = spans if spans is not None else Spans()
        self._lock = threading.Lock()
        self.flusher = DirtyPageFlusher(
            self.alloc, n_targets, trigger=flush_trigger,
            max_pending_per_dev=max_pending_per_target)
        self.checker = StalenessChecker(
            is_evicted=lambda r: self.alloc.where.get(r.tag) !=
            r.set_idx * self.alloc.set_size + r.slot,
            is_clean=lambda r: not self._is_dirty(r),
            current_score=lambda r: self.alloc.flush_score_of(r.set_idx, r.slot),
            score_threshold=0,
        )
        self.exec = IOExecutor(n_targets, self._do_io, max_inflight=2,
                               reserved=1)

    def _is_dirty(self, r: FlushRequest) -> bool:
        p = self.alloc.where.get(r.tag)
        return p is not None and bool(self.alloc.dirty[p])

    # -- io ---------------------------------------------------------------
    def _do_io(self, target: int, payload) -> None:
        import time
        if self._offload_delay:
            time.sleep(self._offload_delay)
        if payload["op"] == "offload":
            tag = payload["tag"]
            # the copy-out, its wait for the engine's pool lock included
            with self.spans.span("kv.offload", f"tag={tag}"):
                data = self._copy_out(tag)
                if data is not None:
                    with self._lock:
                        self.host_tier[tag] = data
                        self.alloc.mark_clean(tag)
                        self.alloc.stats.offloads += 1
        else:                                     # fetch (HIGH)
            tag = payload["tag"]
            self._copy_in(tag, self.host_tier[tag])
            with self._lock:
                self.alloc.mark_clean(tag)        # content == host copy
                self.alloc.stats.fetches += 1
            payload["done"].release()

    # -- flusher pump (paper §3.3) -----------------------------------------
    def note_page_full(self, set_idx: int) -> None:
        self.flusher.note_write(set_idx)
        self.pump()

    def pump(self, budget: int = 8) -> None:
        for fr in self.flusher.make_requests(budget, max_visits=16):
            self.exec.submit(fr.device, IORequest(
                payload={"op": "offload", "tag": fr.tag, "fr": fr},
                priority=LOW,
                is_stale=lambda p, fr=fr: self.checker(fr),
                on_complete=lambda p, fr=fr: self.flusher.note_flush_done(fr),
                on_discard=lambda p, fr=fr: self._on_discard(fr)))

    def _on_discard(self, fr: FlushRequest) -> None:
        with self._lock:
            self.alloc.stats.stale_discards += 1
        self.flusher.note_flush_discarded(fr)

    # -- synchronous paths ---------------------------------------------------
    def offload_now(self, tag: int) -> None:
        """Blocking offload (dirty eviction / preemption of unflushed page)."""
        data = self._copy_out(tag)
        if data is not None:
            with self._lock:
                self.host_tier[tag] = data
                self.alloc.mark_clean(tag)
                self.alloc.stats.offloads += 1

    def offload_now_evicted(self, tag: int, page_id: int, copy_out) -> None:
        """Save a just-evicted dirty victim's content (slot metadata already
        reassigned, device content still intact until the first new write)."""
        data = copy_out(tag, page_id)
        if data is not None:
            with self._lock:
                self.host_tier[tag] = data
                self.alloc.stats.offloads += 1

    def mark_redirtied(self, tag: int) -> None:
        """New tokens written into a page that had a host copy: the copy is
        stale (paper §3.3.2 rule (ii) inverse) — drop it, re-dirty."""
        p = self.alloc.where.get(tag)
        if p is not None:
            self.alloc.dirty[p] = True
        self.host_tier.pop(tag, None)

    def fetch(self, tags: list[int]) -> None:
        """HIGH-priority parallel fetch host->device (resume path)."""
        import threading as _t
        sem = _t.Semaphore(0)
        todo = [t for t in tags if t in self.host_tier]
        for tag in todo:
            self.exec.submit(tag % self.exec._queues.__len__(), IORequest(
                payload={"op": "fetch", "tag": tag, "done": sem},
                priority=HIGH))
        for _ in todo:
            sem.acquire()

    def close(self):
        self.exec.shutdown()
