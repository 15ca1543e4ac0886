"""Serve a small model with batched requests over the paged KV pool,
showing the paper's machinery end to end: set-associative placement, GClock
clean-first eviction, background pre-cleaning (flusher), preemption with
HIGH-priority resume fetches, stale-flush discard.

  PYTHONPATH=src python -m repro_torch.launch.serve_paged [--arch A] [--device cuda|cpu]

The twin of ``examples/serve_paged.py``: reduced qwen3-8b by default, random
weights from seed 0, a pool of 4 sets x 3 pages of 8 tokens that 8 requests
overflow, so some are preempted and resumed. ``--device`` defaults to cuda
and raises if there is no card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.transformer import init_params
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)

    # pool deliberately small: 12 pages of 8 tokens -> preemption under load
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3,
                      device=device)
    rng = np.random.default_rng(0)
    rids = []
    for _ in range(8):
        prompt = [int(x) for x in rng.integers(1, cfg.vocab, int(rng.integers(4, 28)))]
        rids.append(eng.submit(prompt, max_new=16))

    eng.run(max_steps=1200)
    for rid in rids:
        r = eng.result(rid)
        print(f"req {rid}: {r.state:9s} prompt={len(r.prompt):2d} tokens "
              f"-> {r.out[:8]}{'...' if len(r.out) > 8 else ''}")
    print("\npool stats:", eng.stats())
    eng.close()
    return eng


if __name__ == "__main__":
    main()
