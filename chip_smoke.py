#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py [--seed N]

Phases, each printing its own lines; any failure exits non-zero before the
last line:

  1. device   the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build    compile the hand-written CUDA kernels from ``src/`` (timed);
  3. kernels  each kernel against its plain PyTorch version on the card, on
              the kernel tests' shapes and the serving path's shape (fp32
              tolerance 2e-5, bf16 3e-2, a length-0 row must give 0); times
              of the kernel, the plain version and a PyTorch library call;
  4. exact    qwen3-8b at full width in fp32, depth cut to 2 layers: the
              serving engine (paged kernel) under pool pressure must emit the
              greedy tokens of dense prefill + decode with plain attention,
              with preemptions, offloads and fetches all > 0;
  5. serve    qwen3-8b at full width and depth in bf16 (random weights from
              --seed): 12 requests must all finish; the first decode step's
              logits with the kernel must match those with the plain version;
              tokens/s and the median decode-step time;
  6. the kernels line (JSON), the device line, and the result line.

The kernel launch counts are set to 0 just before phases 4 and 5 and read
just after, to show the serving path ran through the kernels.

It needs a CUDA card, and exits non-zero when there is none. It imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

F32_TOL, BF16_TOL = 2e-5, 3e-2
BF16_PEAK_FLOPS = 989e12            # H100 SXM dense bf16 (data sheet)
PAGED_CASES = [
    # b, h, kv, hd, page, max_pages, pool  (tests/test_kernels.py)
    (4, 8, 2, 64, 16, 8, 64),
    (2, 4, 4, 128, 32, 4, 16),
    (3, 6, 6, 32, 8, 16, 128),
    (1, 16, 8, 64, 64, 4, 8),
]
SLICE_CASE = (4, 32, 8, 128, 16, 64, 65)  # qwen3-8b decode: B, H, KV, hd, page, max_pages, pool


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def hbm_bytes_per_s(name: str) -> float:
    """HBM rate of an H100 from its name (data sheet): PCIe 2.0 TB/s, SXM 3.35."""
    return 2.0e12 if "PCIe" in name else 3.35e12


def free_memory(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: kernel against plain version
# ---------------------------------------------------------------------------

def paged_inputs(torch, case, dtype, rng, lengths=None):
    b, h, kv, hd, page, maxp, pool = case
    dev = "cuda"
    q = torch.from_numpy(rng.normal(size=(b, h, hd)).astype(np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.normal(size=(pool, page, kv, hd)).astype(np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.normal(size=(pool, page, kv, hd)).astype(np.float32)).to(dev, dtype)
    table = torch.from_numpy(rng.integers(0, pool, size=(b, maxp)).astype(np.int32)).to(dev)
    if lengths is None:
        lengths = rng.integers(1, maxp * page, size=(b,))
    lengths = torch.tensor(np.asarray(lengths, np.int32)).to(dev)
    return q, k, v, table, lengths


def time_ms(torch, fn, iters: int) -> float:
    """Eager time of one call, host launch overhead included."""
    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int, reps: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph and
    replayed, so the host's launch overhead is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def phase_kernels(torch, seed: int, card: str) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in PAGED_CASES:
            cases.append((f"paged{case}", case, dtype, None, 0.0))
        cases.append(("softcap", (2, 4, 2, 32, 8, 4, 16), dtype, [5, 30], 30.0))
        cases.append(("len0+page-edges", (5, 4, 2, 16, 8, 4, 16), dtype, [0, 1, 8, 9, 32], 0.0))
        cases.append(("slice-shape", SLICE_CASE, dtype, None, 0.0))
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, case, dtype, lengths, cap in cases:
        q, k, v, table, lens = paged_inputs(torch, case, dtype, rng, lengths)
        out = ops.paged_attention(q, k, v, table, lens, softcap=cap)
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(q, k, v, table, lens, softcap=cap)
        err = (out.float() - want.float()).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        ok = bool(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol))
        zero_rows = (lens == 0).nonzero().flatten()
        if len(zero_rows):
            ok = ok and bool((out[zero_rows] == 0).all())
        errs[dtype] = max(errs[dtype], err)
        print(f"[kernels] paged_attention {name} {str(dtype)[6:]}: max_abs_err {err:.3e} "
              f"(tol {tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"paged_attention {name} {dtype}: kernel disagrees with plain version")

    # times at the serving path's shape: bf16, lengths like the serve phase's
    # (prompt 4-48 + up to 24 new tokens); 36 pool copies, one per layer, so
    # the K/V working set exceeds the 50 MB L2 as on the serving path
    b, h, kv, hd, page, maxp, pool = SLICE_CASE
    lens_np = rng.integers(4, 72, size=(b,))
    q, _, _, table, lens = paged_inputs(torch, SLICE_CASE, torch.bfloat16, rng, lens_np)
    layers = 36
    kpools = torch.randn((layers, pool, page, kv, hd), device="cuda").to(torch.bfloat16)
    vpools = torch.randn((layers, pool, page, kv, hd), device="cuda").to(torch.bfloat16)
    kernel_eager_ms = time_ms(torch, lambda i: ops.paged_attention(
        q, kpools[i % layers], vpools[i % layers], table, lens), 10 * layers)
    kernel_ms = graph_ms(torch, lambda i: ops.paged_attention(
        q, kpools[i % layers], vpools[i % layers], table, lens), layers)
    plain_ms = graph_ms(torch, lambda i: ref.paged_attention_ref(
        q, kpools[i % layers], vpools[i % layers], table, lens), layers)
    # library yardstick: gather the pages the longest row needs, then SDPA
    n_pages = -(-int(lens_np.max()) // page)
    s_ctx = n_pages * page
    idx = table[:, :n_pages].long()
    mask = (torch.arange(s_ctx, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qs = q[:, :, None, :]

    def library(i):
        kc = kpools[i % layers][idx].reshape(b, s_ctx, kv, hd).transpose(1, 2)
        vc = vpools[i % layers][idx].reshape(b, s_ctx, kv, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask, enable_gqa=True)

    library_ms = graph_ms(torch, library, layers)
    lib_err = (library(0)[:, :, 0].float()
               - ref.paged_attention_ref(q, kpools[0], vpools[0], table, lens).float()
               ).abs().max().item()
    keys = int(lens_np.sum())
    moved = (keys * kv * hd * 2 * 2            # K and V rows read, bf16
             + 2 * b * h * hd * 2              # q read, out written
             + int((-(-lens_np // page)).sum()) * 4 + b * 4)   # table entries, lengths
    flops = 4 * keys * h * hd                  # q.k and p.v
    bw = hbm_bytes_per_s(card)
    bound_s = max(moved / bw, flops / BF16_PEAK_FLOPS)
    bound_by = "bytes" if moved / bw >= flops / BF16_PEAK_FLOPS else "operations"
    print(f"[kernels] paged_attention at B{b} H{h} KV{kv} hd{hd} page{page} bf16, lengths "
          f"{lens_np.tolist()}: device time (CUDA graph replay) kernel {kernel_ms * 1e3:.2f} us, "
          f"plain {plain_ms * 1e3:.2f} us, "
          f"gather+sdpa {library_ms * 1e3:.2f} us (err vs plain {lib_err:.2e}), bound "
          f"{bound_s * 1e6:.3f} us by {bound_by} ({moved} B at {bw / 1e12:.2f} TB/s) "
          f"on {card}", flush=True)
    print(f"[kernels] paged_attention eager call (host launch included): "
          f"{kernel_eager_ms * 1e3:.2f} us on {card}", flush=True)
    del kpools, vpools
    free_memory(torch)
    return {"cases": len(cases), "max_err_fp32": errs[torch.float32],
            "max_err_bf16": errs[torch.bfloat16], "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "eager_ms": kernel_eager_ms}


# ---------------------------------------------------------------------------
# phase 4: exactness at full width under pool pressure
# ---------------------------------------------------------------------------

def dense_greedy(torch, T, params, cfg, prompt, n):
    toks = torch.tensor([prompt], device="cuda")
    last, cache = T.prefill(params, toks, cfg, max_seq=128)
    out = []
    t = last[:, -1, :].argmax(-1)[:, None]
    for _ in range(n):
        out.append(int(t[0, 0]))
        lg, cache = T.decode_step(params, t, cache, cfg)
        t = lg[:, -1, :].argmax(-1)[:, None]
    return out


def phase_exact(torch, seed: int, kernel) -> int:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServeEngine

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=2, dtype="float32")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3,
                      device="cuda")
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 250, int(rng.integers(3, 20)))]
               for _ in range(6)]
    rids = [eng.submit(p, max_new=24) for p in prompts]
    kernel.launches = 0
    eng.run(800)
    torch.cuda.synchronize()
    launches = kernel.launches
    eng.close()
    st = eng.stats()
    print(f"[exact] qwen3-8b widths fp32, 2 layers, page 8, 4x3 sets, 6 requests: "
          f"stats {st}, paged_attention launches {launches}", flush=True)
    check(all(eng.result(r).state == "done" for r in rids), "exact: a request did not finish")
    check(st["preemptions"] > 0 and st["offloads"] > 0 and st["fetches"] > 0,
          "exact: the pool-pressure path (preempt, offload, fetch) was not exercised")
    check(launches > 0, "exact: the engine did not launch the paged_attention kernel")
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            want = dense_greedy(torch, T, params, cfg, p, 24)
            check(eng.result(rid).out == want, f"exact: request {rid} differs from dense "
                  f"decode: {eng.result(rid).out} vs {want}")
    print("[exact] engine tokens == dense prefill+decode tokens for all 6 requests", flush=True)
    del params, eng
    free_memory(torch)
    return launches


# ---------------------------------------------------------------------------
# phase 5: serve at full width and depth
# ---------------------------------------------------------------------------

class TimedStep:
    """Wraps the engine's decode step and times each call (to a synchronize).

    The first call runs the step twice on the same inputs: once with the
    plain attention in the kernel's place, for the logits, then with the
    kernel, holding each of its launches to the plain version on the same
    inputs. Its output is the kernel run's; it is not timed."""

    def __init__(self, torch, step_fn):
        self.torch, self.step_fn, self.ms, self.first = torch, step_fn, [], None

    def _first_step(self, args):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        kernel_fn = ops.paged_attention
        calls = []

        def checked(*a, **kw):
            out = kernel_fn(*a, **kw)
            want = ref.paged_attention_ref(*a, **kw).float()
            calls.append(((out.float() - want).abs().max().item(),
                          bool(torch.allclose(out.float(), want, atol=BF16_TOL, rtol=BF16_TOL))))
            return out

        try:
            ops.paged_attention = ref.paged_attention_ref
            plain = self.step_fn(*args)
            ops.paged_attention = checked
            got = self.step_fn(*args)
        finally:
            ops.paged_attention = kernel_fn
        self.first = {
            "calls": len(calls), "calls_ok": all(ok for _, ok in calls),
            "call_max_abs_err": max(e for e, _ in calls),
            "logits_max_abs_err": (got - plain).abs().max().item(),
            "logits_rel_l2": ((got - plain).norm() / plain.norm()).item(),
            "argmax_equal_rows": int((got.argmax(-1) == plain.argmax(-1)).sum()),
            "rows": got.shape[0]}
        return got

    def __call__(self, *args):
        if self.first is None:
            return self._first_step(args)
        t0 = time.perf_counter()
        out = self.step_fn(*args)
        self.torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def profile_steps(torch, eng, cfg, rng, median_step_ms: float, card: str) -> dict:
    """torch.profiler over 5 decode steps of 4 fresh requests (admitted and
    prefilled before the window): device time per step by kernel, and the
    device's busy share of an unprofiled step (the main run's median)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(4):
        eng.submit([int(x) for x in rng.integers(1, cfg.vocab, 16)], max_new=8)
    eng.step()                                   # admission + prefill, outside the window
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run(max_steps=100)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 / steps for e in kernels}
    busy = sum(dev_ms.values())
    groups = {"gemm": 0.0, "paged_attention": 0.0, "other": 0.0}
    for name, ms in dev_ms.items():
        key = ("paged_attention" if "paged_attention" in name else
               "gemm" if ("gemm" in name or "nvjet" in name or "cutlass" in name) else "other")
        groups[key] += ms
    out = {"steps": steps, "device_ms_per_step": busy, "groups_ms_per_step": groups,
           "busy_share_of_median_step": busy / median_step_ms if busy else None,
           "top": sorted(((ms, name[:90]) for name, ms in dev_ms.items()), reverse=True)[:8]}
    if not busy:
        print("[profile] the profiler recorded no device time: device busy share not measured")
        return out
    print(f"[profile] {steps} decode steps at batch 4: device busy {busy:.2f} ms per step "
          f"(gemm {groups['gemm']:.2f}, paged_attention {groups['paged_attention']:.3f}, other "
          f"{groups['other']:.2f}) = {100 * out['busy_share_of_median_step']:.1f} % of the "
          f"unprofiled median step {median_step_ms:.2f} ms on {card}", flush=True)
    for ms, name in out["top"]:
        print(f"[profile]   {ms:8.3f} ms/step  {name}")
    return out


def phase_serve(torch, seed: int, kernel, card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServeEngine

    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[serve] qwen3-8b bf16 {cfg.n_layers} layers d_model {cfg.d_model}: "
          f"{n_params / 1e9:.3f}B params drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    eng = ServeEngine(cfg, params, max_batch=4, page_size=16, num_sets=16, set_size=4,
                      device="cuda")
    timed = TimedStep(torch, eng.step_fn)
    eng.step_fn = timed
    rng = np.random.default_rng(seed)
    rids = []
    for _ in range(12):
        n = int(rng.integers(4, 48))
        rids.append(eng.submit([int(x) for x in rng.integers(1, cfg.vocab, n)], max_new=24))
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    t0 = time.perf_counter()
    eng.run(max_steps=5000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernel.launches
    done = sum(eng.result(r).state == "done" for r in rids)
    toks = sum(len(eng.result(r).out) for r in rids)
    first = timed.first
    res = {"done": done, "requests": len(rids), "tokens": toks, "seconds": dt,
           "tokens_per_s": toks / dt, "decode_steps": len(timed.ms) + 1,
           "median_step_ms": statistics.median(timed.ms), "first_step": first,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "stats": eng.stats(), "card": card}
    print(f"[serve] first decode step: {first['calls']} kernel launches vs plain version on the "
          f"same inputs max_abs_err {first['call_max_abs_err']:.3e} (tol {BF16_TOL:g}) "
          f"{'ok' if first['calls_ok'] else 'FAIL'}; logits with kernel vs with plain attention: "
          f"max_abs_err {first['logits_max_abs_err']:.3e}, relative L2 {first['logits_rel_l2']:.3e} "
          f"(tol {BF16_TOL:g}), argmax equal in {first['argmax_equal_rows']}/{first['rows']} rows",
          flush=True)
    print(f"[serve] {done}/{len(rids)} done, {toks} tokens in {dt:.2f} s: "
          f"{res['tokens_per_s']:.1f} tokens/s, median decode step "
          f"{res['median_step_ms']:.2f} ms over {res['decode_steps']} steps, peak "
          f"{res['peak_gb']:.1f} GB, paged_attention launches {launches} on {card}", flush=True)
    print(f"[serve] stats {eng.stats()} on {card}", flush=True)
    check(first["calls_ok"] and first["calls"] == cfg.n_layers,
          "serve: a kernel launch of the first decode step differs from the plain version")
    check(first["logits_rel_l2"] <= BF16_TOL,
          "serve: first-step logits with the kernel differ from those with plain attention")
    check(done == len(rids), f"serve: only {done}/{len(rids)} requests finished")
    check(launches == cfg.n_layers * res["decode_steps"],
          f"serve: {launches} kernel launches for {res['decode_steps']} decode steps")
    res["profile"] = profile_steps(torch, eng, cfg, rng, res["median_step_ms"], card)
    eng.close()
    del params, eng, timed
    free_memory(torch)
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as paged_mod

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(f"[device] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    try:
        # 2. build
        t0 = time.perf_counter()
        paged_mod._kernel()
        log = _build.build_logs.get("paged_attention", "(library already built)")
        print(f"[build] paged_attention.cu built and loaded in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        # 3-5
        kern = phase_kernels(torch, args.seed, card)
        exact_launches = phase_exact(torch, args.seed, paged_mod.paged_attention)
        serve = phase_serve(torch, args.seed, paged_mod.paged_attention, card)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    kernels = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:74",
        "launches": serve["launches"], "max_abs_err": max(kern["max_err_fp32"],
                                                          kern["max_err_bf16"]),
        "ms": kern["ms"], "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "cases": kern["cases"], "max_err_fp32": kern["max_err_fp32"],
        "max_err_bf16": kern["max_err_bf16"], "us": kern["ms"] * 1e3,
        "sdpa_us": kern["library_ms"] * 1e3, "eager_ms": kern["eager_ms"],
        "exact_phase_launches": exact_launches,
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
