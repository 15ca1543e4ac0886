"""The transplanted flusher in the paged-KV serving engine, with and without
background pre-cleaning: how many page offloads block a preemption (the
serving analogue of the paper's Fig 3/5, blocking work off the critical
path); the twin of ``benchmarks/serving_bench.py``.

The same traffic runs twice through ``ServeEngine``, flusher on and then
off: ``n_requests`` prompts of 16 random tokens, ``max_new`` new tokens
each, batch 4, page 8, a pool of 4 sets x 3 pages, so rows are preempted.
The result has JAX ``run()``'s keys (``flusher_on``, ``flusher_off``: the
engine's ``stats()`` with ``tokens`` and ``wall_s``;
``blocking_offload_reduction``), and for each run the requests' tokens
(``outputs``), ``tokens_per_s`` and the median decode step
(``median_step_ms``, to a synchronize). It is written to
``build/bench_torch/serving_flusher.json``.

  PYTHONPATH=src python -m repro_torch.benchmarks.serving_bench [--arch A] [--full] [--device cpu]

Reduced ``--arch`` (tinyllama-1.1b) by default, its published size with
``--full`` (bf16); random weights from ``--seed`` drawn on the device, or
``params`` passed to ``run``. ``--device`` defaults to cuda and raises if
there is no card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.transformer import init_params
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import resolve_device

OUT = Path("build/bench_torch")


def _timed(step_fn, device, times: list):
    """``step_fn`` that appends each call's ms, to a synchronize, to ``times``."""
    def step(*args):
        t0 = time.perf_counter()
        out = step_fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return step


def run(arch: str = "tinyllama-1.1b", n_requests: int = 8, max_new: int = 24, seed: int = 5,
        *, full: bool = False, device="cuda", params=None, weight_seed: int = 0,
        out_dir: Path | None = OUT) -> dict:
    """Both runs; ``params`` (the config's tree on ``device``) replaces the
    random weights drawn from ``weight_seed``. Written to ``out_dir`` unless
    it is None."""
    device = resolve_device(device)
    cfg = get_config(arch) if full else reduced(get_config(arch))
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(weight_seed), device)
    out: dict = {}
    for use_flusher in (True, False):
        eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3,
                          use_flusher=use_flusher, device=device)
        times: list = []
        eng.step_fn = _timed(eng.step_fn, device, times)
        rng = np.random.default_rng(seed)
        prompts = [[int(x) for x in rng.integers(1, 250, 16)] for _ in range(n_requests)]
        rids = [eng.submit(p, max_new=max_new) for p in prompts]
        t0 = time.perf_counter()
        try:
            eng.run(2000)
            dt = time.perf_counter() - t0
            st = eng.stats()
            outputs = [eng.result(r).out for r in rids]
            st.update(tokens=sum(len(o) for o in outputs), wall_s=dt,
                      done=sum(eng.result(r).state == "done" for r in rids),
                      outputs=outputs, decode_steps=len(times),
                      median_step_ms=statistics.median(times) if times else None)
            st["tokens_per_s"] = st["tokens"] / dt
        finally:
            eng.close()
        out["flusher_on" if use_flusher else "flusher_off"] = st
    on, off = out["flusher_on"], out["flusher_off"]
    out["blocking_offload_reduction"] = off["blocking_offloads"] - on["blocking_offloads"]
    out["config"] = {"arch": arch, "full": full, "layers": cfg.n_layers, "dtype": cfg.dtype,
                     "device": str(device), "requests": n_requests, "max_new": max_new,
                     "seed": seed}
    if device.type == "cuda":
        out["config"]["card"] = torch.cuda.get_device_name(device)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "serving_flusher.json").write_text(json.dumps(out, indent=1, default=float))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true", help="the published size, bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    args = ap.parse_args(argv)
    r = run(args.arch, full=args.full, device=args.device, weight_seed=args.seed)
    on, off = r["flusher_on"], r["flusher_off"]
    for name, st in (("w/ flusher: ", on), ("w/o flusher:", off)):
        print(f"serving {name} blocking_offloads={st['blocking_offloads']} "
              f"clean_evictions={st['clean_evictions']} stale_discards={st['stale_discards']} "
              f"offloads={st['offloads']} fetches={st['fetches']} "
              f"preemptions={st['preemptions']} {st['tokens_per_s']:.1f} tokens/s, median "
              f"step {st['median_step_ms']:.2f} ms on {r['config']['device']}")
    print(f"blocking offloads removed from the critical path: "
          f"{r['blocking_offload_reduction']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
