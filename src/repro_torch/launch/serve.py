"""Serving driver: continuous batching over the paged KV pool.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --preset full

``--preset smoke`` serves the reduced config (CPU-sized), ``full`` the
published one (qwen3-8b: 16.4 GB of bf16 weights, one H100). Weights are
random, drawn on the device from ``--seed``. ``--device`` defaults to cuda
and raises if there is no card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.transformer import init_params
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--num-sets", type=int, default=16)
    ap.add_argument("--set-size", type=int, default=4)
    ap.add_argument("--no-flusher", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      page_size=args.page, num_sets=args.num_sets,
                      set_size=args.set_size,
                      use_flusher=not args.no_flusher, device=device)
    rng = np.random.default_rng(args.seed)
    rids = []
    for _ in range(args.requests):
        n = int(rng.integers(4, 48))
        rids.append(eng.submit([int(x) for x in rng.integers(1, cfg.vocab, n)],
                               max_new=args.max_new))
    t0 = time.time()
    eng.run(max_steps=5000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    done = sum(eng.result(r).state == "done" for r in rids)
    toks = sum(len(eng.result(r).out) for r in rids)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{done}/{len(rids)} done, {toks} tokens in {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s) on {where}")
    print("pool stats:", eng.stats())
    eng.close()
    return eng


if __name__ == "__main__":
    main()
