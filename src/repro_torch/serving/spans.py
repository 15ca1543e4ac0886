"""Spans and counters of the serving engine and its offload tier.

One ``Spans`` per engine, shared with its ``PagedKVPool``: per name the
total ``perf_counter_ns`` time and the count of ``span`` blocks, and plain
counts from ``add``, all under a lock of its own (the IO threads record
too). ``ServeEngine.stats()`` reads them.

While a profiler records, a span also opens ``record_function(name)``, so
it sits on the trace's timeline beside the device's kernels; a span with an
``ident`` (a request id, a page tag) opens a second range named by it inside
the first, so one request's ranges share a name an operator can search for.
Without a profiler a span costs two clock reads, a lock and two dict updates.
"""
from __future__ import annotations

import threading
import time

import torch

from repro_torch.models.layers import profiling as _profiling


class _Span:
    __slots__ = ("owner", "name", "ident", "ranges", "t0")

    def __init__(self, owner: "Spans", name: str, ident):
        self.owner, self.name, self.ident, self.ranges = owner, name, ident, ()

    def __enter__(self):
        if _profiling():
            names = (self.name,) if self.ident is None else (self.name, str(self.ident))
            self.ranges = [torch.profiler.record_function(n) for n in names]
            for r in self.ranges:
                r.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        owner = self.owner
        with owner._lock:
            owner._ns[self.name] = owner._ns.get(self.name, 0) + dt
            owner._n[self.name] = owner._n.get(self.name, 0) + 1
        for r in reversed(self.ranges):
            r.__exit__(*exc)


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self._ns: dict[str, int] = {}
        self._n: dict[str, int] = {}

    def span(self, name: str, ident=None) -> _Span:
        """``with spans.span(name, ident):`` times the block under ``name``."""
        return _Span(self, name, ident)

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._n[name] = self._n.get(name, 0) + n

    def seconds(self, name: str) -> float:
        with self._lock:
            return self._ns.get(name, 0) / 1e9

    def count(self, name: str) -> int:
        """Spans of ``name`` closed so far, or the sum ``add`` gave it."""
        with self._lock:
            return self._n.get(name, 0)
