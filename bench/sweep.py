"""Sweep of an open-loop serving cell's traffic over rates, in one process:
how a cell's pool and rate were chosen (not a cell of the benchmark).

    python3 bench/sweep.py --workload olmoe-chat-pressure --seed 7 --seconds 50 \
        --num-sets 60 --rates 1.0 1.2 1.4 [--drain 10] [--out build/sweep.json]

For each rate, a fresh engine (the same weights) with ``--num-sets`` sets
runs the cell's traffic at that rate for ``--seconds``. Per rate it
prints and writes: the mean KV pages the active rows hold and the mean
active rows over the window's steps, the requests in the system and
waiting for admission over each third of the window, the time to first
token and inter-token tails, and the engine's preemptions and blocking
offloads.

The backlog grows at a rate where the mean count waiting for admission
over the window's last third exceeds that over its middle third by more
than one request (the first third fills an empty system, so it is not
compared). The knee is the highest rate of the ascending list at which,
and at every lower rate, the backlog does not grow; the cell's rate is
0.8 x the knee, rounded down to 0.01/s. Both are printed last and written.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

import common


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--num-sets", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--drain", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = common.load_json("workloads", args.workload)
    conf = common.load_json("configs", cell["config"])
    common.keep_caches_in_checkout()
    common.program_path()
    import torch

    from model import port_config
    from reference import family

    common.card_check(torch, 1)
    cfg = port_config(conf)
    params = family(conf).draw_params(conf["port"], args.seed, "cuda")
    cell = {**cell, "engine": {**cell["engine"], "num_sets": args.num_sets},
            "drain_s": args.drain}
    print(f"sweep: {args.workload} on {torch.cuda.get_device_name(0)}, power limit "
          f"{common.power_limit()}, {args.num_sets} sets x {cell['engine']['set_size']}",
          flush=True)
    rows = []
    for rate in args.rates:
        rows.append(sweep_rate(cell, cfg, params, rate, args.seed, args.seconds, "cuda"))
        print("sweep: " + json.dumps(rows[-1]), flush=True)
    knee, rate = choose_rate(rows)
    print(f"sweep: knee {knee} requests/s, the cell's rate {rate} requests/s", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "seed": args.seed,
                                              "seconds": args.seconds,
                                              "num_sets": args.num_sets, "rows": rows,
                                              "knee": knee, "rate": rate}, indent=1))
    found = common.forbidden_loaded()
    if found:
        sys.exit(f"sweep: the process holds {found}")


def sweep_rate(cell: dict, cfg, params, rate: float, seed: int, seconds: float,
               device: str) -> dict:
    """One rate: a fresh engine on ``params``, warmed up, the cell's traffic
    at ``rate`` over ``seconds`` and the drain; the row of readings."""
    import torch

    import serve

    traffic = common.load_module("traffic", cell["traffic_kind"])
    engine = serve.engine_for(cfg, params, cell["engine"], device)
    for prompt in traffic.warmup(cell["traffic_params"], seed, cfg.vocab):
        engine.submit(prompt, max_new=4)
    engine.run(max_steps=256)
    stats0 = engine.stats()
    work = traffic.generate({**cell["traffic_params"], "rate": rate}, seed, seconds, cfg.vocab)
    probes = []

    def probe(eng, tracks, now):
        if now > seconds:
            return
        active = [eng.result(r) for r in tracks if eng.result(r).state == "active"]
        waiting = sum(1 for tr in tracks.values() if not tr.times)
        in_system = sum(1 for r in tracks if eng.result(r).state != "done")
        probes.append((now, sum(len(r.pages) for r in active), len(active), waiting,
                       in_system))

    w = serve.drive(engine, work, seconds, cell, common.Spans(torch),
                    common.TraceWindow(torch, False, 0.0), False, time.perf_counter(),
                    on_step=probe)
    stats = {k: v - stats0[k] for k, v in w["engine_stats"].items()}
    ttft, itl = serve.latencies(w["tracks"], len(work) - w["submitted"])
    third = seconds / 3
    parts = {"first": [p for p in probes if p[0] < third],
             "middle": [p for p in probes if third <= p[0] < 2 * third],
             "last": [p for p in probes if p[0] >= 2 * third]}
    mean = lambda ps, k: statistics.fmean(p[k] for p in ps) if ps else float("nan")
    row = {"rate": rate, "requests": len(work), "steps": w["steps"],
           "mean_live_pages": mean(probes, 1), "mean_active_rows": mean(probes, 2),
           **{f"waiting_{k}_third": mean(ps, 3) for k, ps in parts.items()},
           **{f"in_system_{k}_third": mean(ps, 4) for k, ps in parts.items()},
           **{f"ttft_p{q}_ms": common.percentile(ttft, q) for q in (50, 90)},
           **{f"itl_p{q}_ms": common.percentile(itl, q) for q in (50, 95)},
           "unfinished": sum(1 for r in w["tracks"] if engine.result(r).state != "done"),
           **{k: stats[k] for k in ("preemptions", "blocking_offloads", "offloads",
                                    "fetches")}}
    row["backlog_grows"] = grows(row)
    engine.close()
    del engine, w
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return row


def grows(row: dict) -> bool:
    """The backlog grows: more than one request more waiting for admission,
    on average, over the window's last third than over its middle third."""
    return row["waiting_last_third"] - row["waiting_middle_third"] > 1.0


def choose_rate(rows: list) -> tuple[float | None, float | None]:
    """(the knee, 0.8 x the knee rounded down to 0.01/s) over the rows in
    ascending rate; (None, None) where the backlog grows at the lowest."""
    knee = None
    for row in sorted(rows, key=lambda r: r["rate"]):
        if row["backlog_grows"]:
            break
        knee = row["rate"]
    return knee, None if knee is None else math.floor(80 * knee + 1e-9) / 100


if __name__ == "__main__":
    main()
