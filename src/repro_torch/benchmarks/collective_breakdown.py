"""The top collectives, FLOPs and memory-proxy bytes of one dry-run cell,
by operator and by module path (``launch/cost.py``'s breakdown): the
"profile" of the dry-run world; the twin of
``benchmarks/collective_breakdown.py``.

  PYTHONPATH=src python -m repro_torch.benchmarks.collective_breakdown \\
      --arch olmoe-1b-7b --shape train_4k [--mesh single] [--top 15] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import run_cell


def breakdown(arch: str, shape: str, mesh_kind: str = "single", top: int = 15,
              remat: bool = True, device: str = "cuda") -> dict:
    """Runs the cell with the breakdown on, prints its top rows and returns
    the breakdown (``by_op``, ``by_path``: (flops, bytes, collective bytes);
    ``collectives_by_path``: {(kind, path): bytes})."""
    res = run_cell(arch, shape, mesh_kind, device=device, remat=remat, verbose=False,
                   breakdown=True)
    b = res["breakdown"]
    print(f"== {arch} x {shape} x {mesh_kind} ({device} route) ==")
    print("-- collectives (per-device bytes) --")
    for (kind, path), n in sorted(b["collectives_by_path"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"{n / 1e9:9.3f} GB  {kind:18s} {path[-120:]}")
    for col, title in ((0, "flops"), (1, "memory-proxy bytes")):
        print(f"-- {title}, by operator --")
        tot = sum(v[col] for v in b["by_op"].values()) or 1
        for key, v in sorted(b["by_op"].items(), key=lambda kv: -kv[1][col])[:top]:
            print(f"{v[col]:12.4e} ({v[col] / tot * 100:5.1f}%)  {key}")
        print(f"-- {title}, by module path --")
        for key, v in sorted(b["by_path"].items(), key=lambda kv: -kv[1][col])[:top]:
            print(f"{v[col]:12.4e} ({v[col] / tot * 100:5.1f}%)  {key[-120:]}")
    return b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    breakdown(args.arch, args.shape, args.mesh, args.top, remat=not args.no_remat,
              device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
