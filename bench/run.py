"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``bench/workloads/<cell>.json``,
its configuration in ``bench/configs/<config>.json``, its traffic
generator in ``bench/traffic/<kind>.py``, and each metric's reader in
``bench/metrics/<metric>.py``; ``BENCHMARK.json`` says which metrics a
cell reports. With ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones read from a profiled run. The last line
of standard output is the result; the numbers that decided ``correct``
are the last lines of standard error and the result's last key.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402

import common  # noqa: E402


def execute(name: str, cell: dict, conf: dict, seed: int, seconds: float, trace: bool,
            device: str, chips: int = 1, fault=None, bench: dict | None = None,
            t_process: float = T_PROCESS) -> dict:
    """One run of cell ``name``; returns the result line as a dict (with
    ``checks``). The tests call it on the CPU at a small size."""
    import torch

    driver = __import__(cell["driver"])
    rec = driver.run(cell, conf, seed, seconds, trace, device, t_process, fault=fault)
    e2e, layer = common.cell_metrics(name, bench)
    metrics = {}
    for m in (layer if trace else e2e):
        value = common.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": all(c["held"] for c in rec["checks"].values()),
              "attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
              "device": dev}
    if trace and rec["trace"] is not None:
        tr = rec["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = rec["checks"]
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = common.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        sys.exit(f"bench: no cell {args.workload!r} in BENCHMARK.json")
    cell = common.load_json("workloads", args.workload)
    conf = common.load_json("configs", cell["config"])
    common.keep_caches_in_checkout()
    common.program_path()
    import torch

    common.card_check(torch, entry["chips"])
    print(f"bench: {args.workload} seed {args.seed} on {torch.cuda.get_device_name(0)}, "
          f"power limit {common.power_limit()}, torch {torch.__version__}", flush=True)
    result = execute(args.workload, cell, conf, args.seed, args.seconds, bool(args.trace),
                     "cuda", entry["chips"], bench=bench)
    checks = result.pop("checks")
    common.emit(result, checks)


if __name__ == "__main__":
    main()
