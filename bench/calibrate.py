"""The readings a cell's limits are set from, in one process. Not a cell of
the benchmark, and never run by it.

Serving: for each seed, a run of the cell's traffic at its own load (a
window of ``--seconds``, then the drain), and on the sample the run would
judge, the program's gap numbers and, for the first ``--control`` seeds,
the control's: the reference computed in float8 put in the program's
place (``reference.judge.served_gaps``).

Training: for each seed, the program's first steps as a run's set-up
makes them, against the float32 reference; for the first ``--control``
seeds also the float8 reference and the fault of half of each batch left
out (planted in the reference put in the program's place), each against
the float32 reference, with every leaf's gap.

    python3 bench/calibrate.py --workload olmoe-chat-pressure --seconds 20 \
        --seeds 11 12 13 ... [--control 3] [--out build/calibrate.json]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import common


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--sample-tokens", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = common.load_json("workloads", args.workload)
    conf = common.load_json("configs", cell["config"])
    common.keep_caches_in_checkout()
    common.program_path()
    import torch

    import serve
    from model import port_config
    from reference import family, judge

    common.card_check(torch, 1)
    if args.sample_tokens:
        cell["check"]["sample_tokens"] = args.sample_tokens
    cfg = port_config(conf)
    if cell["driver"] == "train":
        rows = [train_seed(cell, conf, seed, n < args.control) for n, seed in
                enumerate(args.seeds)]
        return finish(args, rows)
    traffic = common.load_module("traffic", cell["traffic_kind"])
    rows = []
    for n, seed in enumerate(args.seeds):
        params = family(conf).draw_params(conf["port"], seed, "cuda")
        engine = serve.engine_for(cfg, params, cell["engine"], "cuda")
        work = traffic.generate(cell["traffic_params"], seed, args.seconds, cfg.vocab)
        tw = common.TraceWindow(torch, False, 0.0)
        w = serve.drive(engine, work, args.seconds, cell, common.Spans(torch), tw, False,
                        time.perf_counter())
        finished = [(tr.prompt, list(engine.result(r).out), tr.preempted)
                    for r, tr in w["tracks"].items() if engine.result(r).state == "done"]
        engine.close()
        del engine, w
        gc.collect()
        torch.cuda.empty_cache()
        picked = judge.sample(finished, seed, cell["check"]["sample_tokens"])
        gaps = judge.served_gaps(params, conf, picked, control=n < args.control)
        row = {"seed": seed, "finished": len(finished), "sampled": len(picked),
               "served_tokens": sum(len(f[1]) for f in picked),
               "preempted_sampled": sum(f[2] for f in picked),
               **{f"{side}_{k}": v for side, g in gaps.items()
                  for k, v in judge.gap_numbers(g).items()}}
        rows.append(row)
        print("calibrate: " + json.dumps(row), flush=True)
        del params
        torch.cuda.empty_cache()
    finish(args, rows)


def train_seed(cell: dict, conf: dict, seed: int, control: bool) -> dict:
    import torch

    import train
    from reference import family, judge, train_ref

    t0 = time.perf_counter()
    params, state, step, feed, prog = train.build(cell, conf, seed, "cuda")
    del params, state, step
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    weights = family(conf).draw_params(conf["port"], seed, "cuda")
    batches = [feed(k) for k in range(cell["checked_steps"])]
    args = (weights, conf, batches, cell["optimizer"], cell["microbatches"])
    ref = train_ref.run_steps(*args)
    t2 = time.perf_counter()
    row = {"seed": seed, "program_s": t1 - t0, "reference_s": t2 - t1,
           "ref_losses": ref["losses"], "program_losses": prog["losses"]}
    sides = {"program": prog}
    if control:
        sides["control"] = train_ref.run_steps(*args, precision="fp8")
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
        sides["half_batch"] = train_ref.run_steps(weights, conf, half, cell["optimizer"],
                                                  cell["microbatches"])
    for side, got in sides.items():
        nums = judge.train_numbers(got, ref)
        row[side] = {k: nums[k] for k in ("loss_gap", "first_grad_gap", "change_gap")}
        row[side]["losses"] = got["losses"]
        row[side]["grad_leaves"] = judge.leaf_gaps(got["first_grad"], ref["first_grad"],
                                                   ref["first_grad"])
        row[side]["change_leaves"] = judge.leaf_gaps(got["change"], ref["change"],
                                                     ref["change"])
    row["left_out"] = nums["left_out"]
    print("calibrate: " + json.dumps(row), flush=True)
    del weights, batches, args, ref, sides
    torch.cuda.empty_cache()
    return row


def finish(args, rows: list) -> None:
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows},
                                             indent=1))
    found = common.forbidden_loaded()
    if found:
        sys.exit(f"calibrate: the process holds {found}")


if __name__ == "__main__":
    main()
