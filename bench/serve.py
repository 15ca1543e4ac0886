"""The serving cells: the program's ``ServeEngine`` driven by a cell's
traffic, the served tokens judged against the plain reference.

Program names this driver calls or wraps (each listed in ``PERF.md``):
``repro_torch.serving.engine.ServeEngine`` (the constructor, ``submit``,
``step``, ``run``, ``result``, ``stats``, ``close``); ``step_fn``,
``_prefill_row`` and ``_preempt`` are wrapped on the instance for spans
and counts.

The traffic is open loop (a traffic module's ``MODE`` ``open_loop``):
requests due on a schedule from the window's start, submitted when due
whatever the engine's state; after the window the run waits up to
``drain_s`` for the requests due in it. A time to first token runs from
the request's due time to its first token (the end of its prefill, which
syncs for the token); the inter-token gaps are every gap between
successive tokens of those requests, preemption included.
"""
from __future__ import annotations

import gc
import math
import time

from common import Spans, TraceWindow, load_module, percentile
from model import port_config


class Track:
    """One request: when it was due, when each of its tokens reached the host."""

    __slots__ = ("due", "rid", "prompt", "times", "preempted")

    def __init__(self, due: float, prompt: list[int], rid: int):
        self.due, self.prompt, self.rid = due, prompt, rid
        self.times: list[float] = []
        self.preempted = False


def _hook(engine, spans: Spans, tracks: dict, clock, sync: bool) -> None:
    """Spans and counts on the engine instance's calls; with ``sync`` (a
    traced run) the decode span ends at a synchronize."""
    step_fn, prefill_row, preempt = engine.step_fn, engine._prefill_row, engine._preempt

    def decode(*args):
        with spans.span("decode", sync=sync):
            return step_fn(*args)

    def prefill(req, tokens):
        with spans.span("prefill"):
            prefill_row(req, tokens)
        spans.add("prompt_tokens", len(tokens))
        if req.rid in tracks:
            tracks[req.rid].times.append(clock())

    def preempted(req):
        with spans.span("preempt"):
            preempt(req)
        if req.rid in tracks:
            tracks[req.rid].preempted = True

    engine.step_fn, engine._prefill_row, engine._preempt = decode, prefill, preempted


def _new_tokens(engine, live: dict, now: float) -> int:
    """Time ``now`` each token a live request gained beyond those already
    timed; drop the finished from ``live``. Returns the count."""
    n = 0
    for rid, tr in list(live.items()):
        req = engine.result(rid)
        while len(tr.times) < len(req.out):
            tr.times.append(now)
            n += 1
        if req.state == "done":
            del live[rid]
    return n


def engine_for(cfg, params, ep: dict, device):
    from repro_torch.serving.engine import ServeEngine

    return ServeEngine(cfg, params, max_batch=ep["max_batch"], page_size=ep["page_size"],
                       num_sets=ep["num_sets"], set_size=ep["set_size"],
                       max_pages=ep["max_pages"], use_flusher=ep["flusher"], device=device)


def drive(engine, work: list, seconds: float, cell: dict, spans: Spans, tw: TraceWindow,
          sync: bool, t_process: float, on_step=None) -> dict:
    """Hook the engine, then the measured window and the drain.
    ``on_step(engine, tracks, now)`` runs after every step in the window
    (the sweep's probes)."""
    tracks: dict[int, Track] = {}
    t0 = [time.perf_counter()]
    clock = lambda: time.perf_counter() - t0[0]
    _hook(engine, spans, tracks, clock, sync)
    live: dict[int, Track] = {}
    if tw.torch.cuda.is_available():
        tw.torch.cuda.synchronize()
        tw.torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process
    closed = None
    drain_end = seconds + cell["drain_s"]
    out_tokens, steps, lateness, i = 0, 0, [], 0
    t0[0] = time.perf_counter()
    while True:
        tw.maybe_start(clock())
        now = clock()
        with spans.span("arrivals"):
            while i < len(work) and work[i][0] <= now:
                due, prompt, max_new = work[i]
                tr = Track(due, prompt, engine.submit(prompt, max_new=max_new))
                tracks[tr.rid] = live[tr.rid] = tr
                lateness.append(now - due)
                i += 1
        if not live:
            if i == len(work):
                break
            time.sleep(max(0.0, min(work[i][0] - clock(), 0.01)))
            continue
        if clock() > drain_end:
            break
        with spans.span("step"):
            engine.step()
        out_tokens += _new_tokens(engine, live, clock())
        steps += 1
        if on_step is not None:
            on_step(engine, tracks, clock())
        tw.tick()
        if closed is None and clock() >= seconds:
            closed = _close(engine, spans, out_tokens, steps)
            tw.stop()
            # a minute past the close (and past the trace's stop) for the due requests
            drain_end = clock() + cell["drain_s"]
    if closed is None:
        closed = _close(engine, spans, out_tokens, steps)
    tw.stop()
    return {"tracks": tracks, "lateness": lateness, "submitted": i, "setup_s": setup_s,
            **closed, "window_s": float(seconds)}


def _close(engine, spans: Spans, out_tokens: int, steps: int) -> dict:
    """What the window counted when it closed; the spans stop there (the
    drain and the check's steps are not measured)."""
    spans.on = False
    return {"engine_stats": engine.stats(), "out_tokens": out_tokens, "steps": steps}


def latencies(tracks: dict, unsubmitted: int) -> tuple[list, list]:
    """Each request's time to first token (infinite if none came, and for
    each request never submitted) and every gap between its tokens, in ms."""
    ttft = [(tr.times[0] - tr.due) * 1e3 if tr.times else math.inf for tr in tracks.values()]
    itl = [(b - a) * 1e3 for tr in tracks.values() for a, b in zip(tr.times, tr.times[1:])]
    return ttft + [math.inf] * unsubmitted, itl


def run(cell: dict, conf: dict, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, fault=None) -> dict:
    """One run of a serving cell. Returns the record the metrics are read
    from, with ``checks`` (each compared number, its limit, and whether it
    held). ``fault`` (the tests) gets the engine after warm-up and may
    break the timed path underneath."""
    import torch

    from reference import family, judge

    cfg = port_config(conf)
    params = family(conf).draw_params(conf["port"], seed, device)
    engine = engine_for(cfg, params, cell["engine"], device)
    traffic = load_module("traffic", cell["traffic_kind"])
    work = traffic.generate(cell["traffic_params"], seed, seconds, cfg.vocab)
    for prompt in traffic.warmup(cell["traffic_params"], seed, cfg.vocab):
        engine.submit(prompt, max_new=4)
    engine.run(max_steps=256)
    if fault is not None:
        fault(engine)
    stats0 = engine.stats()
    spans = Spans(torch, traced=trace)
    tw = TraceWindow(torch, trace, min(seconds, cell["trace_seconds"]), seconds, at_end=True)
    tw.prime()
    w = drive(engine, work, seconds, cell, spans, tw, trace, t_process)
    stats = {k: v - stats0[k] for k, v in w["engine_stats"].items()}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    tracks = w["tracks"]
    done = {rid for rid in tracks if engine.result(rid).state == "done"}
    finished = [(tr.prompt, list(engine.result(rid).out), tr.preempted)
                for rid, tr in tracks.items() if rid in done]
    attempted = len(work)
    failed = attempted - len(done)
    ttft, itl = latencies(tracks, len(work) - w["submitted"])
    lat = w["lateness"]
    print(f"bench: generator lateness ms: median {percentile(lat, 50) * 1e3:.3f}, "
          f"max {max(lat, default=0.0) * 1e3:.3f}, over {len(lat)} submissions")
    print(f"bench: window {w['window_s']:.3f} s, {w['steps']} steps, {w['out_tokens']} tokens "
          f"out, {attempted} attempted, {failed} failed, engine {stats}")

    # the program's state goes before the reference runs (the engine's
    # wrapped methods hold it in a cycle, hence the collection)
    engine.close()
    del engine
    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    checks = judge.served(params, conf, finished, cell, seed, failed)
    return {**w, "ttft_ms": ttft, "itl_ms": itl, "attempted": attempted, "failed": failed,
            "spans": spans, "stats": stats, "trace": tw.reduce(),
            "conf": conf, "cell": cell, "memory_peak_bytes": peak, "checks": checks}
