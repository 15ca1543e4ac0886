"""Synthetic-token data pipeline with host-side prefetch (the port's copy of
``repro/data/pipeline.py``).

The prefetch queue is the data-plane instance of the paper's thesis: a deep
per-consumer buffer hides unsynchronized producer stalls (page-cache misses,
network FS hiccups) from the synchronous train loop. ``Prefetcher``
produces batches in the background while the step runs.

Tokens are deterministic functions of (seed, step) — restart-reproducible,
no files — drawn from a Zipfian unigram over the vocab with a Markov-ish
second-gram mix so the loss has learnable structure. ``SyntheticLM`` and
``Prefetcher`` are numpy and threads, copied unchanged. ``to_device`` puts
a host batch on one device; ``make_global_batch`` (JAX's, host numpy to
arrays sharded over a mesh) makes DTensors of it.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.sharding import PartitionSpec, placements


@dataclass
class SyntheticLM:
    """Deterministic synthetic LM stream."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_s: float = 1.2

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed << 20) ^ step)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = self._rng(step)
        b, s, v = self.global_batch, self.seq_len, self.vocab
        ranks = rng.zipf(self.zipf_s, size=(b, s + 1)) % v
        # mix in local structure: token_{t+1} correlates with token_t
        shift = (ranks[:, :-1] * 31 + 7) % v
        use_prev = rng.random((b, s)) < 0.25
        seq = ranks[:, 1:].copy()
        seq[use_prev] = shift[use_prev]
        tokens = np.concatenate([ranks[:, :1], seq], axis=1).astype(np.int32)
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "mask": np.ones((b, s), np.float32),
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Host numpy -> tensors on ``device``. For a CUDA device each array goes
    through a pinned host buffer and a ``non_blocking`` copy on the current
    stream (the caching host allocator keeps the buffer until the copy has
    run); for the CPU the tensors share the arrays' memory."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                  else t.to(device))
    return out


def make_global_batch(batch: dict[str, np.ndarray], mesh, spec, device) -> dict:
    """Host numpy -> DTensors on ``mesh``, dim 0 placed by ``spec`` (a
    ``PartitionSpec`` such as ``data_spec(mesh, batch)``; its first entry
    only, the other dims replicated, as JAX's train driver passes
    ``P(dspec[0], None)``). Every rank holds the whole global batch (drawn
    from one seed) and keeps its own rows, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import PartitionSpec, placements

    pl = placements(PartitionSpec(spec[0] if len(spec) else None), mesh)
    return {k: distribute_tensor(t, mesh, pl, src_data_rank=None)
            for k, t in to_device(batch, device).items()}


class Prefetcher:
    """Depth-``depth`` background prefetch of an iterator (straggler cover).

    depth sizes the low-priority buffer exactly like the paper's long flush
    queues: production continues while the consumer is busy, so a slow step
    (or a slow producer) never leaves the other side idle.
    """

    def __init__(self, it: Iterator, depth: int = 4):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = False
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop:
                    return
                self._q.put(item)
        except BaseException as e:     # surfaced on next __next__
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
