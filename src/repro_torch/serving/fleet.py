"""Serving-fleet scenario generator: thousands of KV-spill sessions -> trace.
A copy of ``repro/serving/fleet.py`` for the PyTorch port, over the port's
``PagedKVPool`` and ``trace_shim``: the same ``FleetConfig`` and seed give
the same trace array as the JAX package's (``tests/test_torch_trace.py``).

Drives a REAL ``PagedKVPool`` (no-op copy callbacks — the device arrays are
irrelevant to the IO pattern) through the ``trace_shim`` recorder with a
deterministic synthetic serving fleet:

* session arrivals follow a diurnal sinusoid (rate modulated by
  ``diurnal_amp`` over ``diurnal_periods`` periods across the run) sampled
  as a per-step Poisson count — bursty AND slowly varying, the two arrival
  regimes the GC-coordination results care about;
* two tenant classes: interactive (tenant 0 — short sessions, preempted
  and resumed, fetch-heavy) and batch (tenant 1 — long sessions,
  write-heavy). Checkpoint chunk writes, when a ``CheckpointManager`` is
  attached by the caller, ride as tenant ``trace_shim.CKPT_TENANT``;
* every full KV page goes through the pool's genuine flusher pipeline
  (``note_page_full`` -> dual-priority queues -> offload or stale discard),
  blocking dirty-eviction spills are recorded via ``record_direct``, and
  session resume fetches run HIGH priority — the paper's §3.3 machinery
  produces the trace, not a synthetic op mix.

Same ``FleetConfig`` + seed => byte-identical trace array (the RNG is a
single seeded ``default_rng`` consumed in one fixed order; the clock is
logical). Tags encode ``session * PAGES_PER_SESSION_CAP + page_idx`` so
``tag % n_targets`` spreads each session's pages across the array and the
recorder's ``tenant_of`` can map any tag back to its session's tenant.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.workloads import TRACE_WRITE
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.trace_shim import ServingTraceRecorder

__all__ = ["FleetConfig", "FleetResult", "run_fleet",
           "PAGES_PER_SESSION_CAP"]

# tag layout: tag = session_id * CAP + page_idx (page_idx < CAP). Prime,
# and so coprime to any realistic n_targets: device = tag % n_targets then
# mixes the session id in, instead of collapsing to page_idx % n_targets
# (a power-of-two CAP would pin page k of EVERY session to the same device).
PAGES_PER_SESSION_CAP = 67

TENANT_INTERACTIVE = 0
TENANT_BATCH = 1


@dataclass(frozen=True)
class FleetConfig:
    n_targets: int = 8             # spill devices == replay array members
    duration_s: float = 1.0        # logical trace span
    dt: float = 1e-3               # one step of the fleet loop
    arrival_rate: float = 600.0    # mean session arrivals / logical second
    diurnal_amp: float = 0.6       # arrival modulation depth (0..1)
    diurnal_periods: float = 2.0   # sinusoid periods over the run
    page_tokens: int = 64          # tokens per KV page
    interactive_frac: float = 0.6  # tenant 0 share of sessions
    pages_min: int = 2             # session length (pages), inclusive
    pages_max: int = 12            # session length (pages), inclusive
    tokens_per_step_interactive: int = 48
    tokens_per_step_batch: int = 160
    preempt_prob: float = 0.12     # per-step, interactive active sessions
    resume_prob: float = 0.4       # per-step, preempted sessions
    pool_sets: int = 10            # SA sets in the HBM pool
    set_size: int = 8              # slots per set
    flush_trigger: int = 1         # dirty-full pages per set before queueing
    pump_per_device: int = 1       # LOW offloads served per device per step


@dataclass
class FleetResult:
    trace: np.ndarray              # (n, 4) float64 time/lba/op/tenant
    tokens_total: int = 0
    sessions_started: int = 0
    sessions_completed: int = 0
    offloads: int = 0
    fetches: int = 0
    stale_discards: int = 0
    dirty_evictions: int = 0
    alloc_failures: int = 0
    meta: dict = field(default_factory=dict)


class _Session:
    __slots__ = ("sid", "tenant", "n_pages", "pages_done", "tokens_accum",
                 "tags", "state")

    def __init__(self, sid: int, tenant: int, n_pages: int) -> None:
        self.sid = sid
        self.tenant = tenant
        self.n_pages = n_pages
        self.pages_done = 0
        self.tokens_accum = 0
        self.tags: list[int] = []
        self.state = "active"          # active | preempted


def run_fleet(cfg: FleetConfig = FleetConfig(), seed: int = 0,
              recorder: ServingTraceRecorder | None = None) -> FleetResult:
    """Run the fleet against a fresh pool; returns the emitted trace plus
    fleet and pool counters. Pass a ``recorder`` that already has a
    ``CheckpointManager`` attached to interleave checkpoint chunk writes
    with the KV traffic on the same clock."""
    rng = np.random.default_rng(seed)
    tenants: dict[int, int] = {}       # session -> tenant (for tenant_of)
    rec = recorder or ServingTraceRecorder(cfg.n_targets)
    rec._tenant_of = lambda tag: tenants.get(
        tag // PAGES_PER_SESSION_CAP, 0)
    pool = PagedKVPool(cfg.pool_sets, cfg.set_size,
                       n_targets=cfg.n_targets,
                       copy_out=lambda tag: (),
                       copy_in=lambda tag, data: None,
                       flush_trigger=cfg.flush_trigger)
    rec.attach_pool(pool)

    res = FleetResult(trace=np.empty((0, 4)))
    sessions: dict[int, _Session] = {}
    next_sid = 0
    pages_cap = min(cfg.pages_max, PAGES_PER_SESSION_CAP - 1)
    steps = int(round(cfg.duration_s / cfg.dt))
    two_pi = 2.0 * np.pi

    def alloc_page(tag: int):
        page, evicted_tag, evicted_dirty = pool.alloc.alloc(tag)
        if page is not None and evicted_tag is not None and evicted_dirty:
            # blocking spill of the dirty victim: a synchronous device
            # write the executor never sees — record it explicitly
            pool.offload_now_evicted(evicted_tag, page, lambda t, p: ())
            rec.record_direct(evicted_tag, TRACE_WRITE,
                              tenants.get(
                                  evicted_tag // PAGES_PER_SESSION_CAP, 0))
        return page

    def fill_page(s: _Session) -> None:
        tag = s.sid * PAGES_PER_SESSION_CAP + s.pages_done
        if alloc_page(tag) is None:
            res.alloc_failures += 1
            return
        s.tags.append(tag)
        s.pages_done += 1
        res.tokens_total += cfg.page_tokens
        pool.alloc.mark_full(tag)
        pool.note_page_full(pool.alloc.set_of(tag))

    def finish(s: _Session) -> None:
        pool.alloc.set_pinned(s.tags, False)
        pool.alloc.free(s.tags)        # queued offloads now discard stale
        for tag in s.tags:
            pool.host_tier.pop(tag, None)
        res.sessions_completed += 1

    for step in range(steps):
        t = step * cfg.dt
        # diurnal/bursty arrivals
        rate = cfg.arrival_rate * (1.0 + cfg.diurnal_amp * np.sin(
            two_pi * cfg.diurnal_periods * t / cfg.duration_s))
        for _ in range(int(rng.poisson(max(rate, 0.0) * cfg.dt))):
            tenant = (TENANT_INTERACTIVE
                      if rng.random() < cfg.interactive_frac
                      else TENANT_BATCH)
            n_pages = int(rng.integers(cfg.pages_min, pages_cap + 1))
            sessions[next_sid] = _Session(next_sid, tenant, n_pages)
            tenants[next_sid] = tenant
            next_sid += 1
            res.sessions_started += 1

        done: list[int] = []
        for sid, s in sessions.items():
            if s.state == "preempted":
                if rng.random() < cfg.resume_prob:
                    # pages evicted while preempted come back from the
                    # host tier: HIGH-priority fetches (recorded)
                    lost = [tag for tag in s.tags
                            if pool.alloc.where.get(tag) is None
                            and tag in pool.host_tier]
                    for tag in lost:
                        alloc_page(tag)
                    if lost:
                        pool.fetch(lost)
                    pool.alloc.set_pinned(s.tags, True)
                    s.state = "active"
                continue
            per_step = (cfg.tokens_per_step_interactive
                        if s.tenant == TENANT_INTERACTIVE
                        else cfg.tokens_per_step_batch)
            s.tokens_accum += per_step
            while s.tokens_accum >= cfg.page_tokens \
                    and s.pages_done < s.n_pages:
                s.tokens_accum -= cfg.page_tokens
                fill_page(s)
            if s.pages_done >= s.n_pages:
                done.append(sid)
            elif s.tenant == TENANT_INTERACTIVE \
                    and rng.random() < cfg.preempt_prob:
                pool.alloc.set_pinned(s.tags, False)
                s.state = "preempted"
        for sid in done:
            finish(sessions.pop(sid))

        rec.advance(cfg.dt)
        rec.pump(cfg.pump_per_device)

    # close out: abandon the stragglers (their queued offloads go stale),
    # then serve the remaining backlog on the still-advancing clock
    for sid in list(sessions):
        finish(sessions.pop(sid))
    guard = 0
    while rec.backlog() and guard < 100000:
        rec.advance(cfg.dt)
        rec.pump(max(cfg.pump_per_device, 2))
        guard += 1
    pool.close()

    stats = pool.alloc.stats
    res.trace = rec.to_array()
    res.offloads = stats.offloads
    res.fetches = stats.fetches
    res.stale_discards = stats.stale_discards   # == rec.stale_discards()
    res.dirty_evictions = stats.dirty_evictions
    res.meta = {
        "n_targets": cfg.n_targets,
        "page_tokens": cfg.page_tokens,
        "duration_s": cfg.duration_s,
        "seed": seed,
    }
    return res
