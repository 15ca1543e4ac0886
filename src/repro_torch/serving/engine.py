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

Mamba layers keep their state per batch row (``paged_model.init_pools``);
pages hold attention K/V only, so for an attention-free model (mamba2) the
page copies are empty, as in JAX. One deviation from the JAX engine: a
preempted request keeps a copy of its row's mamba state (``_preempt``) and
gets it back when it resumes (``_refill_row``). The JAX engine rebuilds only
the page table there, so a resumed mamba row continues from another
request's state, or from none; keeping the state makes the resumed tokens
those of dense greedy decode. The copy is kept in host memory, as the host
tier keeps pages, so preempted requests hold no device memory: about 1.6 MB
a layer a row for mamba2-780m in float32, 76 MB over its 48 layers.

On a card the decode step is one CUDA graph, captured when the engine is
built and replayed each step (``_decode_fn``): every row of ``max_batch``
runs, the inactive ones masked (``paged_model.make_paged_decode_step``),
from static device buffers that each step fills from the scheduler's
pinned host arrays. On the CPU the same masked step runs eagerly.

The engine times itself (``serving/spans.py``): the decode step split into
the pool lock's wait, the launches and the rest, each prefill, the blocking
offloads and fetch waits of the engine thread, each background copy-out of
the IO threads, and the offload queues' waits; ``stats()`` returns their
totals beside the pool's counters and the graph's replays, and under a
profiler each span is also a ``serve.*`` or ``kv.*`` range on the trace.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from .kv_pool import PagedKVPool
from .paged_model import init_pools, make_paged_decode_step
from .spans import Spans

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
    # the row's mamba state while preempted, in host memory:
    # per mamba position {name: tensor}
    mamba_state: Optional[dict] = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 page_size: int = 16, num_sets: int = 32, set_size: int = 4,
                 max_pages: int = 64, use_flusher: bool = True, device="cuda"):
        T.check_servable(cfg)                   # before any engine state exists
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.tree() if isinstance(params, T.Transformer) else params
        self.page = page_size
        self.max_batch = max_batch
        self.max_pages = max_pages
        self.use_flusher = use_flusher
        n_data_pages = num_sets * set_size
        # reserved, never allocated: the decode step's sink for inactive rows
        self.scratch_page = n_data_pages
        self.pools = init_pools(cfg, num_pages=n_data_pages + 1,
                                page_size=page_size, max_batch=max_batch,
                                device=self.device)
        self.spans = spans = Spans()
        self.pool = PagedKVPool(num_sets, set_size, n_targets=2,
                                copy_out=self._copy_out, copy_in=self._copy_in,
                                # paper: trigger at half the set (6 of 12)
                                flush_trigger=max(0, set_size // 2 - 1),
                                spans=spans)
        self._attn_positions = [i for i, s in enumerate(cfg.block) if s.kind == "attn"]
        self._mamba_positions = [i for i, s in enumerate(cfg.block) if s.kind != "attn"]
        self._reqs: dict[int, Request] = {}
        self._waiting: list[int] = []
        self._rows: list[Optional[int]] = [None] * max_batch
        self._rid = itertools.count()
        # the decode step's inputs (tokens, lengths, page table, active
        # mask): host tensors, pinned on a card, whose numpy views the
        # scheduler edits in place
        inputs = (torch.zeros((max_batch, 1), dtype=torch.long),
                  torch.zeros(max_batch, dtype=torch.int32),
                  torch.full((max_batch, max_pages), self.scratch_page, dtype=torch.int32),
                  torch.zeros(max_batch, dtype=torch.bool))
        if self.device.type == "cuda":
            inputs = tuple(t.pin_memory() for t in inputs)
        self._inputs = inputs
        self._last_tok = inputs[0].numpy()[:, 0]
        self._lengths, self._tables, self._active = (t.numpy() for t in inputs[1:])
        self._pools_lock = threading.Lock()
        self._graph = None
        self.step_fn = self._decode_fn(make_paged_decode_step(cfg, page_size=page_size))
        self.preemptions = 0
        self.blocking_offloads = 0

    def _decode_fn(self, paged_step):
        """``step_fn(params, pools, tokens, lengths, page_table, active)``:
        the decode step, returning its logits once the step is enqueued.
        On a card the step is captured once, here, in a CUDA graph over
        these params and pools and static device copies of the inputs;
        each call copies the inputs in and replays the graph on the
        current stream, so it runs in lock order with the offload threads'
        copies, as the eager step did. That step raises when given other
        params or pools than the engine's, and once the engine is closed. The engine builds its step without a
        mesh (the mesh route, ``make_paged_decode_step(mesh=)``, stays
        eager). On the CPU the step runs eagerly on the inputs given."""
        spans = self.spans
        if self.device.type != "cuda":
            def step_fn(*args):
                with spans.span("serve.decode.launch"):
                    return paged_step(*args)
            return step_fn

        bufs = tuple(torch.empty_like(t, device=self.device) for t in self._inputs)
        for buf, t in zip(bufs, self._inputs):
            buf.copy_(t)
        # every row inactive: the warm-up and capture write only the sink page
        with torch.no_grad():
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(2):        # kernel builds, cuBLAS and the allocator
                    paged_step(self.params, self.pools, *bufs)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._graph = graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                logits = paged_step(self.params, self.pools, *bufs)

        def step_fn(params, pools, *inputs):
            # the graph reads the params and pools it was captured with, and
            # no others; after close() it holds nothing
            if params is not self.params or pools is not self.pools:
                raise ValueError("the decode graph was captured over the engine's own "
                                 "params and pools; it cannot run on others")
            if self._graph is None:
                raise RuntimeError("the engine is closed: its decode graph was released")
            with spans.span("serve.decode.launch"):
                for buf, t in zip(bufs, inputs):
                    buf.copy_(t, non_blocking=True)
                graph.replay()
                spans.add("decode_graph_replays")
                return logits
        return step_fn

    # ------------------------------------------------------------- tags
    def _tag(self, rid: int, page_idx: int) -> int:
        return rid * MAX_PAGES_PER_SEQ + page_idx

    # -------------------------------------------------- device<->host copies
    def _copy_out(self, tag: int, page_id: int | None = None):
        with self._pools_lock:
            pid = self.pool.alloc.where.get(tag) if page_id is None else page_id
            if pid is None:
                return None
            pools = [self.pools[i] for i in self._attn_positions]
            ks = [p["k"][:, pid].to("cpu", copy=True) for p in pools]
            vs = [p["v"][:, pid].to("cpu", copy=True) for p in pools]
        return (ks, vs)

    def _copy_in(self, tag: int, data) -> None:
        with self._pools_lock:
            pid = self.pool.alloc.where.get(tag)
            if pid is None:
                return
            ks, vs = data
            for p, k, v in zip([self.pools[i] for i in self._attn_positions], ks, vs):
                p["k"][:, pid].copy_(k)
                p["v"][:, pid].copy_(v)

    # ------------------------------------------------------------ public
    def submit(self, prompt: list[int], max_new: int = 16) -> int:
        """Queue a request. A prompt the mamba prefill cannot take (longer
        than its chunk and not a multiple of it) raises here, before any
        engine state changes."""
        if self._mamba_positions:
            ssm.check_length(len(prompt))
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
                    with self.spans.span("serve.offload_blocking", f"tag={ev_tag}"):
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
                with self.spans.span("serve.offload_blocking", f"tag={tag}"):
                    self.pool.offload_now(tag)
                self.blocking_offloads += 1
        self.pool.alloc.set_pinned(req.pages, False)
        with self._pools_lock:
            req.mamba_state = {i: {k: a[:, req.row].to("cpu", copy=True)
                                   for k, a in self.pools[i].items()}
                               for i in self._mamba_positions}
        self._rows[req.row] = None
        self._tables[req.row, :] = self.scratch_page
        req.state = "preempted"
        req.row = -1

    def _free(self, req: Request) -> None:
        self.pool.alloc.free(req.pages)
        # scan by rid: host-tier copies of pages evicted while preempted are
        # no longer listed in req.pages but must not leak. The IO threads
        # insert under the pool's lock, so the scan holds it too.
        with self.pool._lock:
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
            with self.spans.span("serve.fetch_wait", f"rid={rid}"):
                self.pool.fetch(fetchable)
            self._refill_row(req, tokens)
        else:
            self._prefill_row(req, tokens)
        return True

    def _prefill_row(self, req: Request, tokens: list[int]) -> None:
        with self.spans.span("serve.prefill", f"rid={req.rid}"):
            row = req.row
            s = len(tokens)
            pad = len(req.pages) * self.page
            toks = torch.tensor([tokens], dtype=torch.long, device=self.device)
            logits, cache = T.prefill(self.params, toks, self.cfg, max_seq=pad)
            # NOTE: prefill caches beyond ``s`` are zeros — masked by lengths.
            with self._pools_lock:
                for i in self._mamba_positions:
                    for k, a in self.pools[i].items():
                        a[:, row] = cache.layers[i][k][:, 0]
                for i in self._attn_positions:
                    p, lc = self.pools[i], cache.layers[i]
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
        self.spans.add("prefill_tokens", len(tokens))

    def _refill_row(self, req: Request, tokens: list[int]) -> None:
        """Resume: pages were fetched back by tag; rebuild the table/row, and
        put back the mamba state kept at ``_preempt`` (the JAX engine does not)."""
        row = req.row
        with self._pools_lock:
            for i, st in req.mamba_state.items():
                for k, a in st.items():
                    self.pools[i][k][:, row].copy_(a)
        req.mamba_state = None
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
        self._active[:] = [r is not None for r in self._rows]
        # serve.decode: the pool lock's wait, the launches (inside step_fn:
        # the inputs' copies and the step), and the wait for the tokens
        with self.spans.span("serve.decode"):
            with self.spans.span("serve.decode.lock"):
                self._pools_lock.acquire()
            try:
                logits = self.step_fn(self.params, self.pools, *self._inputs)
            finally:
                self._pools_lock.release()
            # on a card the step copies its inputs out of the pinned host
            # arrays asynchronously; this copy to the host follows it on the
            # same stream and waits for it, so the arrays are free to edit
            # once it returns
            toks = logits[:, -1, :].argmax(dim=-1).cpu().numpy()
        self.spans.add("decode_rows_active", len(active_rows))
        self.spans.add("decode_rows_computed", len(toks))
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
        """The pool's counters, then the spans' and the offload queues'
        totals since the engine was built: all numbers, seconds (``*_s``) or
        counts, so two readings subtract."""
        s, sp = self.pool.alloc.stats, self.spans
        io = [self.pool.exec.stats(d) for d in range(self.pool.alloc.n_targets)]
        return {
            "offloads": s.offloads, "fetches": s.fetches,
            "stale_discards": s.stale_discards,
            "clean_evictions": s.clean_evictions,
            "dirty_evictions": s.dirty_evictions,
            "alloc_failures": s.alloc_failures,
            "preemptions": self.preemptions,
            "blocking_offloads": self.blocking_offloads,
            "decode_steps": sp.count("serve.decode"),
            "decode_rows_active": sp.count("decode_rows_active"),
            "decode_rows_computed": sp.count("decode_rows_computed"),
            "decode_s": sp.seconds("serve.decode"),
            "decode_lock_s": sp.seconds("serve.decode.lock"),
            "decode_launch_s": sp.seconds("serve.decode.launch"),
            "decode_graph_replays": sp.count("decode_graph_replays"),
            "prefill_s": sp.seconds("serve.prefill"),
            "prefill_tokens": sp.count("prefill_tokens"),
            "blocking_offload_s": sp.seconds("serve.offload_blocking"),
            "fetch_wait_s": sp.seconds("serve.fetch_wait"),
            "offload_io_n": sp.count("kv.offload"),
            "offload_io_s": sp.seconds("kv.offload"),
            "flush_issued": sum(q.issued_low for q in io),
            "flush_wait_s": sum(q.wait_low_s for q in io),
            "fetch_issued": sum(q.issued_high for q in io),
            "fetch_queue_wait_s": sum(q.wait_high_s for q in io),
        }

    def close(self):
        self.pool.close()
        if self._graph is not None:       # its memory goes back to the allocator
            self._graph.reset()
            self._graph = None
