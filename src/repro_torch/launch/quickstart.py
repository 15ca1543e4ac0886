"""Quickstart: the paper's policy machinery on the port, in a few seconds.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cuda|cpu]

The twin of ``examples/quickstart.py``:

1. the SA-cache and its GClock flush scores (``core/sa_cache.py``), scored
   for all sets at once through ``ops.flush_scores`` (the Hopper kernel on
   the card) and checked against the plain version and the per-set numpy
   policy (``core/policies.py``);
2. the dirty-page flusher reading that cache and filling dual-priority
   queues, where an application read overtakes the flush backlog;
3. a tiny end-to-end training run (``launch/train.py``: reduced
   tinyllama-1.1b, 20 steps).

``--device`` defaults to cuda and raises if there is no card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import policies, sa_cache
from repro_torch.core.flusher import DirtyPageFlusher
from repro_torch.core.io_queues import HIGH, LOW, DualQueue, IORequest
from repro_torch.kernels import ref
from repro_torch.launch.train import main as train
from repro_torch.serving.engine import resolve_device

NUM_SETS, SET_SIZE = 4, 12


class View:
    """The flusher's ``CacheView`` of an SA-cache state."""

    def __init__(self, cache: sa_cache.CacheState):
        self.cache = cache

    def dirty_count(self, s):
        return int(sa_cache.dirty_counts(self.cache)[s])

    def flush_candidates(self, s):
        fs = sa_cache.flush_scores(self.cache)[s].cpu().numpy()
        dirty = self.cache.dirty[s].cpu().numpy()
        tags = self.cache.tags[s].cpu().numpy()
        return sorted(((i, int(tags[i]), int(fs[i])) for i in range(SET_SIZE) if dirty[i]),
                      key=lambda t: -t[2])

    def device_of(self, tag):
        return tag % 2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. the policy layer ------------------------------------------------
    cache = sa_cache.make_cache(NUM_SETS, SET_SIZE, device=device)
    for tag in range(40):                        # fill with pages, some dirty
        _, _, _, cache = sa_cache.insert(cache, tag % NUM_SETS, tag, tag % 3 == 0)
    scores = sa_cache.flush_scores(cache)
    print(f"flush scores (on {device}):\n{scores.cpu().numpy()}")
    valid = cache.tags != sa_cache.EMPTY
    plain = ref.flush_scores_ref(cache.hits, cache.clock, valid)
    assert torch.equal(scores, plain), "flush scores differ from the plain version"
    hits, clock, valid_np = cache.hits.cpu().numpy(), cache.clock.cpu().numpy(), valid.cpu().numpy()
    for s in range(NUM_SETS):
        want = policies.flush_scores(hits[s], int(clock[s]), valid=valid_np[s])
        assert (scores[s].cpu().numpy() == want).all(), f"set {s} differs from the policy"
    print("flush scores match the plain version and the per-set numpy policy\n")

    # --- 2. flusher + dual-priority queues ------------------------------------
    fl = DirtyPageFlusher(View(cache), n_devices=2, trigger=2)
    for s in range(NUM_SETS):
        fl.note_write(s)
    q = DualQueue(max_inflight=32, reserved=7)   # paper: 7 of 32 slots reserved
    requests = fl.make_requests(budget=8)
    for fr in requests:
        q.submit(IORequest(payload=fr, priority=LOW))
    q.submit(IORequest(payload="application read", priority=HIGH))
    first = q.pop_next()
    print("first issued request:", first.payload, "(HIGH overtakes the backlog)\n")

    # --- 3. tiny end-to-end training ------------------------------------------
    losses = train(["--arch", "tinyllama-1.1b", "--preset", "smoke", "--steps", "20",
                    "--batch", "8", "--seq", "64", "--lr", "3e-3", "--device", args.device])
    print(f"\ntrained 20 steps: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return {"scores": scores.cpu().numpy(), "requests": requests, "first": first.payload,
            "cache": cache, "losses": losses}


if __name__ == "__main__":
    main()
