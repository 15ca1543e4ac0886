"""Continuous-batching serve engine over the paged KV pool (PyTorch port of
``repro/serving/engine.py``).

Scheduler loop (host) + paged decode step (device):

  submit() -> waiting queue -> admit into free batch rows (prefill writes the
  prompt's KV pages) -> decode all active rows each step -> pages that fill
  trigger the dirty-page flusher (background offload, LOW priority) ->
  finished sequences free their pages (queued offloads become stale and are
  discarded) -> page-pool exhaustion preempts the youngest sequence
  (clean pages drop instantly thanks to pre-cleaning; dirty ones cost a
  blocking offload — counted) -> preempted sequences resume via HIGH-priority
  fetches.

The pools are torch tensors updated in place, and the offload/fetch workers
of the ``IOExecutor`` copy pages out of and into them from other threads. So
every pool write (the decode step's K/V write, ``_prefill_row``,
``_copy_in``) and every page read of ``_copy_out`` holds ``_pools_lock``, and
each host copy completes before the lock is released (``.to("cpu")`` and
``copy_`` from pageable host memory are synchronous). All threads use the
same CUDA stream, so the device runs the copies in the order the lock let
them be issued.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from .kv_pool import PagedKVPool
from .paged_model import init_pools, make_paged_decode_step

MAX_PAGES_PER_SEQ = 512


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device that is not there raises (the
    entry points never drop to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = field(default_factory=list)
    state: str = "waiting"         # waiting | active | preempted | done
    row: int = -1
    length: int = 0
    pages: list[int] = field(default_factory=list)     # tags, in order
    stall_steps: int = 0


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 page_size: int = 16, num_sets: int = 32, set_size: int = 4,
                 max_pages: int = 64, use_flusher: bool = True, device="cuda"):
        T.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.tree() if isinstance(params, T.Transformer) else params
        self.page = page_size
        self.max_batch = max_batch
        self.max_pages = max_pages
        self.use_flusher = use_flusher
        n_data_pages = num_sets * set_size
        self.scratch_page = n_data_pages                  # reserved, never allocated
        self.pools = init_pools(cfg, num_pages=n_data_pages + 1,
                                page_size=page_size, device=self.device)
        self.pool = PagedKVPool(num_sets, set_size, n_targets=2,
                                copy_out=self._copy_out, copy_in=self._copy_in,
                                # paper: trigger at half the set (6 of 12)
                                flush_trigger=max(0, set_size // 2 - 1))
        self.step_fn = make_paged_decode_step(cfg, page_size=page_size)
        self._reqs: dict[int, Request] = {}
        self._waiting: list[int] = []
        self._rows: list[Optional[int]] = [None] * max_batch
        self._rid = itertools.count()
        self._lengths = np.zeros(max_batch, np.int32)
        self._tables = np.full((max_batch, max_pages), self.scratch_page,
                               np.int32)
        self._last_tok = np.zeros(max_batch, np.int64)
        self._pools_lock = threading.Lock()
        self.preemptions = 0
        self.blocking_offloads = 0

    # ------------------------------------------------------------- tags
    def _tag(self, rid: int, page_idx: int) -> int:
        return rid * MAX_PAGES_PER_SEQ + page_idx

    # -------------------------------------------------- device<->host copies
    def _copy_out(self, tag: int, page_id: int | None = None):
        with self._pools_lock:
            pid = self.pool.alloc.where.get(tag) if page_id is None else page_id
            if pid is None:
                return None
            ks = [p["k"][:, pid].to("cpu", copy=True) for p in self.pools]
            vs = [p["v"][:, pid].to("cpu", copy=True) for p in self.pools]
        return (ks, vs)

    def _copy_in(self, tag: int, data) -> None:
        with self._pools_lock:
            pid = self.pool.alloc.where.get(tag)
            if pid is None:
                return
            ks, vs = data
            for p, k, v in zip(self.pools, ks, vs):
                p["k"][:, pid].copy_(k)
                p["v"][:, pid].copy_(v)

    # ------------------------------------------------------------ public
    def submit(self, prompt: list[int], max_new: int = 16) -> int:
        rid = next(self._rid)
        self._reqs[rid] = Request(rid, list(prompt), max_new)
        self._waiting.append(rid)
        return rid

    def result(self, rid: int) -> Request:
        return self._reqs[rid]

    # -------------------------------------------------------- page control
    def _alloc_page(self, req: Request, page_idx: int,
                    allow_preempt: bool = True) -> bool:
        """Allocate (tag); on a fully-pinned set optionally preempt a victim.

        Admission passes allow_preempt=False (a waiting request never kicks
        out an active one — that's the thrash the paper's deep queues avoid);
        only an ACTIVE row growing into its next page may preempt.
        """
        tag = self._tag(req.rid, page_idx)
        while True:
            pid, ev_tag, ev_dirty = self.pool.alloc.alloc(tag)
            if pid is not None:
                if ev_tag is not None and ev_dirty:
                    # blocking offload of the victim's content (stall)
                    self.pool.offload_now_evicted(ev_tag, pid, self._copy_out)
                    self.blocking_offloads += 1
                req.pages.append(tag)
                return True
            if not allow_preempt:
                return False
            victim = self._pick_victim(exclude=req.rid)
            if victim is None:
                return False
            self._preempt(victim)

    def _pick_victim(self, exclude: int) -> Optional[Request]:
        active = [r for r in self._reqs.values()
                  if r.state == "active" and r.rid != exclude]
        if not active:
            return None
        return max(active, key=lambda r: r.rid)        # youngest first (LIFO)

    def _preempt(self, req: Request) -> None:
        self.preemptions += 1
        # partial (dirty, non-full) pages + any un-offloaded full pages must
        # reach the host tier before their slots can be reused
        for tag in req.pages:
            pid = self.pool.alloc.where.get(tag)
            if pid is not None and self.pool.alloc.dirty[pid]:
                if self.pool.alloc.full[pid] and self.use_flusher:
                    req.stall_steps += 1   # flusher hadn't gotten to it yet
                self.pool.offload_now(tag)
                self.blocking_offloads += 1
        self.pool.alloc.set_pinned(req.pages, False)
        self._rows[req.row] = None
        self._tables[req.row, :] = self.scratch_page
        req.state = "preempted"
        req.row = -1

    def _free(self, req: Request) -> None:
        self.pool.alloc.free(req.pages)
        # scan by rid: host-tier copies of pages evicted while preempted are
        # no longer listed in req.pages but must not leak
        for tag in [t for t in self.pool.host_tier
                    if t // MAX_PAGES_PER_SEQ == req.rid]:
            self.pool.host_tier.pop(tag, None)
        req.pages.clear()

    # ------------------------------------------------------------- admit
    def _admit(self, rid: int) -> bool:
        req = self._reqs[rid]
        row = next((i for i, r in enumerate(self._rows) if r is None), None)
        if row is None:
            return False
        resume = req.state == "preempted"
        tokens = req.prompt + req.out
        # consumed tokens occupy positions [0, c); the next decode writes
        # position c -> pages 0 .. c // page must exist.
        consumed = req.length if resume else len(req.prompt)
        n_pages = consumed // self.page + 1
        req.pages = [t for t in req.pages
                     if self.pool.alloc.where.get(t) is not None]
        # re-pin surviving pages FIRST: the alloc loop below must not evict
        # this request's own residents
        self.pool.alloc.set_pinned(req.pages, True)
        survivors = list(req.pages)
        newly: list[int] = []
        for i in range(n_pages):
            tag = self._tag(rid, i)
            if self.pool.alloc.where.get(tag) is None:
                if not self._alloc_page(req, i, allow_preempt=False):
                    # ROLL BACK this attempt's allocations: they hold garbage
                    # (content is only restored by the post-success fetch);
                    # leaving them dirty would later clobber the good host
                    # copies via eviction writeback
                    self.pool.alloc.free(newly)
                    req.pages = survivors
                    self.pool.alloc.set_pinned(survivors, False)
                    return False
                newly.append(tag)
        self.pool.alloc.set_pinned(req.pages, True)
        req.row, req.state = row, "active"
        self._rows[row] = rid
        if resume:
            # fetch by LOGICAL page index, not by the (lossy) tag list —
            # a page evicted while preempted lives only in the host tier
            fetchable = [self._tag(rid, i) for i in range(n_pages)
                         if self._tag(rid, i) in self.pool.host_tier]
            self.pool.fetch(fetchable)
            self._refill_row(req, tokens)
        else:
            self._prefill_row(req, tokens)
        return True

    def _prefill_row(self, req: Request, tokens: list[int]) -> None:
        row = req.row
        s = len(tokens)
        pad = len(req.pages) * self.page
        toks = torch.tensor([tokens], dtype=torch.long, device=self.device)
        logits, cache = T.prefill(self.params, toks, self.cfg, max_seq=pad)
        # NOTE: prefill caches beyond ``s`` are zeros — masked by lengths.
        with self._pools_lock:
            for p, lc in zip(self.pools, cache.layers):
                k = lc["k"][:, 0]                          # (nb, pad, kvh, hd)
                v = lc["v"][:, 0]
                for tag in req.pages:
                    pi = tag % MAX_PAGES_PER_SEQ        # page index from tag
                    pid = self.pool.alloc.where[tag]
                    sl = slice(pi * self.page, (pi + 1) * self.page)
                    p["k"][:, pid] = k[:, sl]
                    p["v"][:, pid] = v[:, sl]
        self._lengths[row] = s
        self._tables[row, :] = self.scratch_page
        for tag in req.pages:
            self._tables[row, tag % MAX_PAGES_PER_SEQ] = \
                self.pool.alloc.where[tag]
        # the prompt's last-position logits emit the FIRST generated token
        first = int(logits[0, -1].argmax())
        req.out.append(first)
        self._last_tok[row] = first
        req.length = s
        # full prompt pages are immediately flushable
        if self.use_flusher:
            for tag in req.pages:
                pi = tag % MAX_PAGES_PER_SEQ
                if (pi + 1) * self.page <= s:
                    self.pool.alloc.mark_full(tag)
                    self.pool.note_page_full(self.pool.alloc.set_of(tag))

    def _refill_row(self, req: Request, tokens: list[int]) -> None:
        """Resume: pages were fetched back by tag; rebuild the table/row."""
        row = req.row
        self._lengths[row] = req.length          # consumed tokens
        self._tables[row, :] = self.scratch_page
        for pi_tag in req.pages:
            pi = pi_tag % MAX_PAGES_PER_SEQ
            self._tables[row, pi] = self.pool.alloc.where[pi_tag]
        self._last_tok[row] = tokens[-1]         # the one unconsumed token

    # --------------------------------------------------------------- loop
    @torch.no_grad()
    def step(self) -> None:
        # admission
        for rid in list(self._waiting):
            if self._admit(rid):
                self._waiting.remove(rid)
        active_rows = [i for i, r in enumerate(self._rows) if r is not None]
        if not active_rows:
            return
        # ensure a page exists for the next position of every active row
        for i in active_rows:
            rid = self._rows[i]
            if rid is None:                      # preempted as a victim above
                continue
            req = self._reqs[rid]
            pi = int(self._lengths[i]) // self.page
            tag = self._tag(req.rid, pi)
            if self.pool.alloc.where.get(tag) is None:
                if not self._alloc_page(req, pi):
                    self._preempt(req)
                    continue
                self._tables[i, pi] = self.pool.alloc.where[tag]
        active_rows = [i for i, r in enumerate(self._rows) if r is not None]
        if not active_rows:
            return
        dev = self.device
        with self._pools_lock:
            logits = self.step_fn(
                self.params, self.pools,
                torch.from_numpy(self._last_tok[:, None]).to(dev),
                torch.from_numpy(self._lengths).to(dev),
                torch.from_numpy(self._tables).to(dev),
                torch.tensor(active_rows, dtype=torch.long, device=dev))
        toks = logits[:, -1, :].argmax(dim=-1).cpu().numpy()
        # GClock touch: every resident page of every active row was read
        for i in active_rows:
            self.pool.alloc.touch(self._reqs[self._rows[i]].pages)
        for i in active_rows:
            req = self._reqs[self._rows[i]]
            # the page written this step diverged from any host copy
            cur_tag = self._tag(req.rid, int(self._lengths[i]) // self.page)
            self.pool.mark_redirtied(cur_tag)
            req.out.append(int(toks[i]))
            self._last_tok[i] = toks[i]
            self._lengths[i] += 1
            req.length += 1
            if self._lengths[i] % self.page == 0 and self.use_flusher:
                tag = self._tag(req.rid, int(self._lengths[i]) // self.page - 1)
                self.pool.alloc.mark_full(tag)
                self.pool.note_page_full(self.pool.alloc.set_of(tag))
            if len(req.out) >= req.max_new:
                req.state = "done"
                self._rows[i] = None
                self._tables[i, :] = self.scratch_page
                self._free(req)
        # resumption of preempted requests
        for req in self._reqs.values():
            if req.state == "preempted" and req.rid not in self._waiting:
                self._waiting.append(req.rid)

    def run(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if all(r.state == "done" for r in self._reqs.values()):
                break
            self.step()

    def stats(self) -> dict:
        s = self.pool.alloc.stats
        return {
            "offloads": s.offloads, "fetches": s.fetches,
            "stale_discards": s.stale_discards,
            "clean_evictions": s.clean_evictions,
            "dirty_evictions": s.dirty_evictions,
            "alloc_failures": s.alloc_failures,
            "preemptions": self.preemptions,
            "blocking_offloads": self.blocking_offloads,
        }

    def close(self):
        self.pool.close()
