"""The training cell: the program's train step (``launch.steps.
make_train_step`` with ``optim.adamw.adamw_init``'s state) over a cell's
batches, its first steps judged against the plain reference.

Program names this driver calls (each listed in ``PERF.md``):
``repro_torch.launch.steps.make_train_step`` and the step it returns,
``repro_torch.optim.adamw.adamw_init`` and the state's ``m`` and
``master`` trees.

Set-up builds one step object with its weights and optimizer state and
drives it through the cell's ``checked_steps`` first steps (they also warm
every shape up); the window takes the same object on. From those steps
it keeps each loss, the norm of each leaf's first gradient as AdamW got
it (its first moment after one step over 1 - b1) and the norm of each
leaf's change over them (the master copy against the weights drawn).
"""
from __future__ import annotations

import gc
import time

import numpy as np

from common import Spans, TraceWindow, load_module
from model import port_config
from reference import family
from reference.train_ref import B1, flat


def build(cell: dict, conf: dict, seed: int, device: str, fault=None):
    """The step object with its weights and optimizer state, driven through
    the cell's ``checked_steps`` first steps. Returns (params, state, step,
    feed, the program's readings)."""
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import adamw_init

    cfg = port_config(conf)
    tp, opt = cell["traffic_params"], cell["optimizer"]
    traffic = load_module("traffic", cell["traffic_kind"])

    def feed(k: int) -> dict:
        b = traffic.batch(tp, seed, k, cfg.vocab)
        return {n: torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)
                for n, a in b.items()}

    params = family(conf).draw_params(conf["port"], seed, device)
    start = {k: v.clone() for k, v in flat(params).items()}
    state = adamw_init(params)
    step = make_train_step(cfg, remat=True, peak_lr=opt["peak_lr"], warmup=opt["warmup"],
                           total_steps=opt["total_steps"], weight_decay=opt["weight_decay"],
                           microbatches=cell["microbatches"])
    if fault is not None:
        step = fault(step)
    prog = {"losses": []}
    for k in range(cell["checked_steps"]):
        params, state, m = step(params, state, feed(k))
        prog["losses"].append(float(m["ce"] + opt["lb_coef"] * m["lb"] + opt["z_coef"] * m["z"]))
        if k == 0:
            prog["first_grad"] = {p: float(t.norm()) / (1 - B1) for p, t in flat(state.m).items()}
    master = flat(state.master if state.master is not None else params)
    prog["change"] = {p: float((master[p] - start[p].float()).norm()) for p in master}
    return params, state, step, feed, prog


def run(cell: dict, conf: dict, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, fault=None) -> dict:
    """One run of a training cell. ``fault`` (the tests) wraps the train
    step (it gets the step and returns the one the run calls)."""
    import torch

    from reference import judge

    params, state, step, feed, prog = build(cell, conf, seed, device, fault)
    tw = TraceWindow(torch, trace, min(seconds, cell["trace_seconds"]))
    tw.prime()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process

    tp = cell["traffic_params"]
    n_checked = cell["checked_steps"]
    spans = Spans(torch, traced=trace)
    rows = tp["batch"]
    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        tw.maybe_start(time.perf_counter() - t0)
        batch = feed(n_checked + steps)
        with spans.span("train_step", sync=True):
            params, state, _ = step(params, state, batch)
        steps += 1
        tw.tick()
    window = time.perf_counter() - t0
    tw.stop()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    print(f"bench: window {window:.3f} s, {steps} steps of {rows} x {tp['seq']}, "
          f"checked losses {prog['losses']}")

    # the program's state goes before the reference runs
    del params, state, step
    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    weights = family(conf).draw_params(conf["port"], seed, device)
    checks = judge.trained(weights, conf, cell, [feed(k) for k in range(n_checked)], prog)
    print(f"bench: the reference took {time.perf_counter() - t_ref:.1f} s")
    return {"setup_s": setup_s, "window_s": window, "tokens": steps * rows * tp["seq"],
            "steps": steps, "attempted": steps, "failed": 0, "spans": spans,
            "trace": tw.reduce(), "conf": conf, "cell": cell, "batch": rows, "seq": tp["seq"],
            "micro_rows": rows // cell["microbatches"], "memory_peak_bytes": peak,
            "checks": checks}
