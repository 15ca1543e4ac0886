"""Async sharded checkpointing built on the paper's machinery.

The mapping (DESIGN.md §2): checkpoint *chunks* are the dirty pages, storage
targets are the SSDs, and the training loop is the application whose writes
must never block.

  * every ``save_async(step, tree)`` marks all (changed) chunks dirty and
    enqueues LOW-priority writes on per-target dual queues (the port's copy of ``core.io_queues``)
    — the train loop continues immediately (paper: flush requests fill the
    long queues);
  * a queued write is discarded at the queue head iff a NEWER save for the
    same chunk has been enqueued (paper §3.3.2 staleness: the page was
    re-dirtied and a fresher flush exists — writing the old version is
    wasted bandwidth);
  * ``restore`` reads run HIGH priority and overtake any backlog of writes
    (paper §3.2: reserved slots keep reads fast under write pressure);
  * a per-target budget (``max_inflight``) plus deep software queues absorb
    stragglers: one slow target (overloaded NFS shard, throttled disk) delays
    only its own chunks — exactly the unsynchronized-GC scenario.

A checkpoint step is COMMITTED by writing ``manifest-<step>.json`` after its
last chunk lands; superseded steps simply never commit (their chunks were
discarded), so restore always sees a consistent, complete step. Chunk files
are content-addressed by (key, step).

The port keeps the chunk and manifest format, so a checkpoint written by the
JAX package restores here and one written here restores there: the keys
are JAX's ``tree_flatten_with_path`` strings (``flatten_with_paths``), and
bf16 leaves are written as JAX's ``np.save`` writes them, their 16 bits
under the header ``'descr': '<V2'``. Restore casts each chunk to the dtype
and device of the leaf it replaces (a ``|V2`` chunk into a bf16 leaf).

A tree of DTensors is saved whole: every rank gathers each leaf
(``full_tensor``, a collective) and only rank 0 writes the chunks and the
manifest. ``restore`` reads whole leaves and places them onto a mesh, that
of ``like``'s DTensors or the one ``shardings`` names, so a checkpoint
restores onto another mesh than the one that saved it, or onto none.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.io_queues import HIGH, LOW, IOExecutor, IORequest
from repro_torch.distributed.sharding import placements
from repro_torch.tree import flatten_with_paths, map_with_path

BF16_BITS = np.dtype("V2")          # a bf16 leaf on the host: its 16 bits, unnamed


def to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` in host memory, as numpy: bf16 as its bits viewed
    ``V2`` (numpy has no bf16), anything else in its own dtype. A DTensor
    is gathered whole first (a collective: every rank of its mesh calls)."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(BF16_BITS)
    return t.to("cpu", copy=True).numpy()


def from_host(a: np.ndarray, like: torch.Tensor, sharding=None) -> torch.Tensor:
    """The chunk ``a`` as a tensor of ``like``'s dtype and device; a ``V2``
    chunk (bf16 bits) goes into a bf16 leaf. Any other dtype or shape that
    differs from ``like``'s raises. ``sharding`` = (mesh, PartitionSpec)
    makes it a DTensor so placed; else a DTensor ``like`` gives its own mesh
    and placements. Every rank holds the whole chunk and keeps its slice."""
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint chunk of shape {a.shape} for a leaf of shape "
                         f"{tuple(like.shape)}")
    if like.dtype == torch.bfloat16 and a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
        if t.dtype != like.dtype:
            raise TypeError(f"checkpoint chunk of dtype {a.dtype} for a leaf of dtype "
                            f"{like.dtype}")
    t = t.to(like.device)
    if sharding is not None:
        mesh, spec = sharding
        return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)
    if isinstance(like, DTensor):
        return distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)
    return t


def save_chunk(path: Path, a: np.ndarray) -> None:
    """``np.save``, except that bf16 bits get the header JAX's ``np.save``
    of a bf16 array writes (``'<V2'``), so the files match byte for byte."""
    if a.dtype != BF16_BITS:
        np.save(path, a, allow_pickle=False)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        a.tofile(f)                      # C order, as np.save writes it


class CheckpointManager:
    """Async checkpoint writer/reader over ``n_targets`` storage targets."""

    def __init__(self, directory: str | Path, *, n_targets: int = 4,
                 max_inflight: int = 2, reserved: int = 1, keep: int = 2,
                 write_delay: float = 0.0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.n_targets = n_targets
        self.keep = keep
        # reserved slots must leave room for LOW-priority writes to flow
        reserved = max(0, min(reserved, max_inflight - 1))
        self._write_delay = write_delay          # fault-injection for tests
        self._lock = threading.Lock()
        self._latest_enqueued: dict[str, int] = {}   # key -> newest step queued
        self._remaining: dict[int, int] = {}         # step -> chunks not landed
        self._committed: list[int] = []
        self.stats = {"written": 0, "discarded_stale": 0, "bytes": 0,
                      "saves": 0, "restores": 0}
        self._exec = IOExecutor(n_targets, self._do_io,
                                max_inflight=max_inflight, reserved=reserved)
        # in a process group, rank 0 alone writes (every rank gathers)
        self._writer = not dist.is_initialized() or dist.get_rank() == 0

    # ------------------------------------------------------------------ io
    def _chunk_path(self, key: str, step: int) -> Path:
        safe = key.replace("/", "__")
        return self.dir / f"{safe}-{step}.npy"

    def _do_io(self, target: int, payload: dict) -> None:
        if payload["op"] == "write":
            if self._write_delay:
                time.sleep(self._write_delay)
            save_chunk(self._chunk_path(payload["key"], payload["step"]), payload["data"])
            with self._lock:
                self.stats["written"] += 1
                self.stats["bytes"] += payload["data"].nbytes
                step = payload["step"]
                if step in self._remaining:
                    self._remaining[step] -= 1
                    if self._remaining[step] == 0:
                        self._commit(step)
        else:                                     # read (HIGH priority)
            payload["out"][payload["key"]] = np.load(
                self._chunk_path(payload["key"], payload["step"]))
            payload["done"].release()

    def _commit(self, step: int) -> None:
        """Called with lock held: all chunks of ``step`` are durable."""
        manifest = {"step": step,
                    "keys": sorted(k for k, s in self._latest_enqueued.items())}
        tmp = self.dir / f".manifest-{step}.tmp"
        tmp.write_text(json.dumps(manifest))
        tmp.rename(self.dir / f"manifest-{step}.json")
        self._committed.append(step)
        del self._remaining[step]
        # retention: drop chunk files of old committed steps
        for old in self._committed[:-self.keep]:
            for f in self.dir.glob(f"*-{old}.npy"):
                f.unlink(missing_ok=True)
            (self.dir / f"manifest-{old}.json").unlink(missing_ok=True)
        self._committed = self._committed[-self.keep:]

    # --------------------------------------------------------------- save
    def save_async(self, step: int, tree: Any,
                   changed: set[str] | None = None) -> None:
        """Enqueue a checkpoint of ``tree`` at ``step``; returns once its
        leaves are copied to host memory (the port updates tensors in place,
        so the copy is taken here, on the caller's thread).

        ``changed`` optionally names the dirty chunks (default: all) — the
        dirty-chunk filter for e.g. frozen towers or unchanged EMA copies.
        In a process group every rank calls it (the gather of a DTensor leaf
        is a collective) and rank 0 alone writes.
        """
        flat = flatten_with_paths(tree)
        with self._lock:
            duplicate = step in self._remaining or step in self._committed
        # every rank gathers a sharded tree, so that all join each gather
        if duplicate and not any(isinstance(v, DTensor) for v in flat.values()):
            return
        host = {k: to_host(v) for k, v in flat.items() if changed is None or k in changed}
        if duplicate or not self._writer:
            return
        with self._lock:
            self.stats["saves"] += 1
            self._remaining[step] = len(host)
            for k in host:
                self._latest_enqueued[k] = step

        def make_stale(key: str, s: int) -> Callable[[Any], bool]:
            def is_stale(_payload) -> bool:
                with self._lock:
                    return self._latest_enqueued.get(key, s) > s
            return is_stale

        def on_discard(payload) -> None:
            with self._lock:
                self.stats["discarded_stale"] += 1
                step_d = payload["step"]
                if step_d in self._remaining:
                    self._remaining[step_d] -= 1
                    # a superseded step never commits; forget it when drained
                    if self._remaining[step_d] <= 0:
                        del self._remaining[step_d]

        for i, (k, v) in enumerate(sorted(host.items())):
            self._exec.submit(
                self._target_of(k),
                IORequest(payload={"op": "write", "key": k, "step": step,
                                   "data": v},
                          priority=LOW,
                          is_stale=make_stale(k, step),
                          on_discard=on_discard))

    def _target_of(self, key: str) -> int:
        return hash(key) % self.n_targets

    # ------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = sorted(int(p.stem.split("-")[1])
                       for p in self.dir.glob("manifest-*.json"))
        return steps[-1] if steps else None

    def restore(self, like: Any, step: int | None = None, shardings: Any = None,
                mesh=None) -> tuple[int, Any]:
        """Blocking restore into the structure of ``like`` (a tree of
        tensors), each leaf in the dtype and on the device of ``like``'s.
        Reads are HIGH priority: they overtake any write backlog.
        ``shardings`` (a tree of ``PartitionSpec`` like ``like``, with
        ``mesh``) places each whole leaf onto ``mesh``, whatever mesh
        saved it (JAX's elastic resume); without it a DTensor leaf of
        ``like`` gives its own placements."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        manifest = json.loads((self.dir / f"manifest-{step}.json").read_text())
        out: dict[str, np.ndarray] = {}
        sem = threading.Semaphore(0)
        for k in manifest["keys"]:
            self._exec.submit(
                self._target_of(k),
                IORequest(payload={"op": "read", "key": k, "step": step,
                                   "out": out, "done": sem},
                          priority=HIGH))
        for _ in manifest["keys"]:
            sem.acquire()
        self.stats["restores"] += 1
        specs = {} if shardings is None else flatten_with_paths(shardings)
        return step, map_with_path(
            lambda key, leaf: from_host(out[key], leaf,
                                        (mesh, specs[key]) if key in specs else None), like)

    # ------------------------------------------------------------- control
    def barrier(self, timeout: float = 120.0) -> bool:
        """Write barrier (paper §3.4): returns once every enqueued write has
        either landed or been discarded stale — everything submitted before
        the barrier is durable (or superseded) before anything after it.
        The paper's caveat holds: frequent barriers forfeit the flusher's
        reordering freedom, so use them at consistency points only."""
        return self._exec.drain(timeout)

    def wait_for_commit(self, step: int, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        path = self.dir / f"manifest-{step}.json"
        while time.monotonic() < deadline:
            if path.exists():
                return True
            time.sleep(0.01)
        return False

    def drain(self, timeout: float = 120.0) -> bool:
        return self._exec.drain(timeout)

    def close(self) -> None:
        self._exec.shutdown()
