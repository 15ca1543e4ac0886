"""Roofline tables from the port's dry-run JSON (``launch/dryrun.py``); the
twin of ``benchmarks/roofline.py``. The terms are derived from an H100
SXM's published peaks (``dryrun.PEAK_FLOPS``, ``HBM_BW``, ``NVLINK_BW``,
``NETWORK_BW``), not measured.

Run the dry run first, then:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--mesh single] [--dir build/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import ARCH_IDS, cells
from repro_torch.launch.dryrun import DEFAULT_OUT


def load(mesh: str = "single", dirs=None) -> list[dict]:
    """The cells' records in arch x shape order, from the first directory
    of ``dirs`` that holds each."""
    rows = []
    for arch in ARCH_IDS:
        for shp in cells(arch):
            for d in dirs or [DEFAULT_OUT]:
                p = Path(d) / f"{arch}_{shp}_{mesh}.json"
                if p.exists():
                    rows.append(json.loads(p.read_text()))
                    break
    return rows


def fmt_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_ms':>10s} {'memory_ms':>10s} "
           f"{'coll_ms':>9s} {'bound':>10s} {'useful':>7s} {'AG_GB':>7s} "
           f"{'AR_GB':>7s} {'trace_s':>7s}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        rf = r["roofline"]
        cb = r["collectives"]["bytes"]
        out.append(
            f"{r['arch']:22s} {r['shape']:12s} "
            f"{rf['compute_s'] * 1e3:10.2f} {rf['memory_s'] * 1e3:10.2f} "
            f"{rf['collective_s'] * 1e3:9.2f} {rf['bottleneck']:>10s} "
            f"{(r['useful_flop_ratio'] or 0):7.3f} "
            f"{cb.get('all-gather', 0) / 1e9:7.2f} "
            f"{cb.get('all-reduce', 0) / 1e9:7.2f} {r['trace_s']:7.1f}")
    return "\n".join(out)


def summarize(rows: list[dict]) -> dict:
    worst = min((r for r in rows if r["mode"] == "train"),
                key=lambda r: r["useful_flop_ratio"] or 0, default=None)
    coll_bound = max(rows, key=lambda r: r["roofline"]["collective_s"] /
                     max(r["roofline"]["compute_s"], 1e-12), default=None)
    return {
        "n_cells": len(rows),
        "worst_useful_train": worst and (worst["arch"], worst["shape"],
                                         worst["useful_flop_ratio"]),
        "most_collective_bound": coll_bound and (coll_bound["arch"], coll_bound["shape"]),
        "bottleneck_histogram": {
            b: sum(1 for r in rows if r["roofline"]["bottleneck"] == b)
            for b in ("compute", "memory", "collective")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--dir", action="append", default=None,
                    help=f"dry-run output directory (default {DEFAULT_OUT}); repeatable")
    args = ap.parse_args(argv)
    rows = load(args.mesh, args.dir)
    if not rows:
        print("no dry-run records found; run repro_torch.launch.dryrun --all first")
        return 1
    print(fmt_table(rows))
    print()
    print(json.dumps(summarize(rows), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
