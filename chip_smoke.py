#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py [--seed N]

Phases, each printing its own lines; any failure exits non-zero before the
last line:

  1. device   the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build    compile the three hand-written CUDA kernels from ``src/``, one
              nvcc each, all at once (timed; registers and spills);
  3. kernels  each kernel against its plain PyTorch version on the card:
              paged attention on the kernel tests' shapes, hd 120 and the
              serving shape (fp32 2e-5, bf16 3e-2, a length-0 row gives 0);
              flash attention on the kernel tests' cases, the q_offset tail,
              hd 120 with window 4096 and qwen3-8b's prefill shape (fp32
              2e-5, bf16 2e-2); flush scores exactly equal on the kernel
              tests' grid and at 2,100 and 131,072 sets of 12; times of each
              kernel, its plain version and a PyTorch library call, and the
              bound;
  4. exact    qwen3-8b at full width in fp32, depth cut to 2 layers: the
              serving engine (flash prefill, paged decode) under pool pressure
              must emit the greedy tokens of prefill + decode with plain
              attention, with preemptions, offloads and fetches all > 0;
  5. serve    qwen3-8b at full width and depth in bf16 (random weights from
              --seed): 12 requests must all finish, with one flash launch per
              layer per request; the first decode step's logits with the
              kernel must match those with the plain version; tokens/s and
              the median decode-step time;
  6. prefill  the same model and weights: 2 requests of 4,096-token prompts
              through the engine (page 16, 32 x 12 sets); each flash launch
              of the first prefill held to the plain version, its logits to
              those of a plain-attention prefill; time to first token;
  7. sa-cache the SA-cache twin: the quickstart twin on the card, and
              ``select_flush_candidates`` at 131,072 x 12 on the card equal
              to the CPU's;
  8. the kernels line (JSON), the device line, and the result line.

The kernel launch counts are set to 0 just before each of phases 4-7 and
read just after, to show each path ran through its kernels.

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
FLASH_BF16_TOL = 2e-2               # tests/test_kernels.py:49
BF16_PEAK_FLOPS = 989e12            # H100 SXM dense bf16 (data sheet)
PAGED_CASES = [
    # b, h, kv, hd, page, max_pages, pool  (tests/test_kernels.py)
    (4, 8, 2, 64, 16, 8, 64),
    (2, 4, 4, 128, 32, 4, 16),
    (3, 6, 6, 32, 8, 16, 128),
    (1, 16, 8, 64, 64, 4, 8),
]
DANUBE_CASE = (2, 32, 8, 120, 16, 8, 32)  # h2o-danube decode: hd 120
SLICE_CASE = (4, 32, 8, 128, 16, 64, 65)  # qwen3-8b decode: B, H, KV, hd, page, max_pages, pool
FLASH_CASES = [
    # b, sq, skv, h, kv, hd, causal, window, softcap, q_offset
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, 0),      # tests/test_kernels.py FLASH_CASES
    (1, 256, 256, 8, 8, 64, True, 64, 50.0, 0),
    (2, 64, 192, 4, 1, 128, False, 0, 0.0, 0),
    (1, 100, 100, 2, 2, 32, True, 0, 0.0, 0),
    (1, 16, 144, 6, 6, 64, True, 0, 0.0, 0),
    (3, 128, 128, 8, 4, 16, True, 32, 0.0, 0),
    (1, 16, 64, 4, 4, 32, True, 0, 0.0, 48),       # the q_offset tail test
    (1, 4608, 4608, 32, 8, 120, True, 4096, 0.0, 0),   # h2o-danube: hd 120, window 4096
]
FLASH_SLICE = (1, 4096, 32, 8, 128)       # qwen3-8b prefill: B, S, H, KV, hd (causal, bf16)
FLUSH_GRID = [(100, 12), (1000, 12), (64, 7), (513, 16), (1, 12), (256, 2),   # tests
              (2100, 12),       # qwen3-8b's KV pool on an 80 GB card: 2.36 MB pages
              (131072, 12)]     # serving scale, 10^5+ sets (kernels/flush_score.py)
PREFILL_TOKENS, PREFILL_NEW = 4096, 8


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
        cases.append(("h2o-danube-hd120", DANUBE_CASE, dtype, None, 0.0))
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


def flash_pairs(sq: int, skv: int, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the masks leave valid: the work of one head."""
    qpos = np.arange(sq)[:, None] + q_offset
    kpos = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return int(mask.sum())


def phase_flash(torch, seed: int, card: str) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(seed + 1)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
        for case in FLASH_CASES:
            b, sq, skv, h, kv, hd, causal, window, cap, q_offset = case
            q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                       .to("cuda", dtype) for shape in
                       ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
            kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
            out = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = (out.float() - want.float()).abs().max().item()
            ok = bool(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol))
            errs[dtype] = max(errs[dtype], err)
            n += 1
            print(f"[kernels] flash_attention {case} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                  f"(tol {tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"flash_attention {case} {dtype}: kernel disagrees with plain version")
            del q, k, v, out, want
            free_memory(torch)

    # times at the prefill path's shape: qwen3-8b, one 4,096-token prompt,
    # causal, bf16; the library yardstick is PyTorch's fused SDPA on (B, H, S, hd)
    b, s, h, kv, hd = FLASH_SLICE
    q, k, v = (torch.randn(shape, device="cuda").to(torch.bfloat16)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    kernel_ms = graph_ms(torch, lambda i: ops.flash_attention(q, k, v), 3, reps=5)
    plain_ms = graph_ms(torch, lambda i: ref.flash_attention_ref(q, k, v), 1, reps=3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = graph_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 3, reps=5)
    lib_err = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
               .transpose(1, 2).float() - ref.flash_attention_ref(q, k, v).float()
               ).abs().max().item()
    flops = 4 * b * h * hd * flash_pairs(s, s, True, 0, 0)      # q.k and p.v
    moved = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)      # q, out, k, v in bf16
    bw = hbm_bytes_per_s(card)
    bound_s = max(moved / bw, flops / BF16_PEAK_FLOPS)
    bound_by = "bytes" if moved / bw >= flops / BF16_PEAK_FLOPS else "operations"
    print(f"[kernels] flash_attention at B{b} S{s} H{h} KV{kv} hd{hd} causal bf16: device time "
          f"(CUDA graph replay) kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"sdpa {library_ms:.3f} ms (err vs plain {lib_err:.2e}), bound {bound_s * 1e3:.4f} ms "
          f"by {bound_by} ({flops:.3e} FLOP at {BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s; {moved} B) "
          f"= {flops / kernel_ms / 1e9:.1f} TFLOP/s achieved on {card}", flush=True)
    del q, k, v, qt, kt, vt
    free_memory(torch)
    return {"cases": n, "max_err_fp32": errs[torch.float32],
            "max_err_bf16": errs[torch.bfloat16], "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "flops": flops}


def flush_inputs(torch, ns: int, ss: int, rng, device="cuda"):
    hits = torch.from_numpy(rng.integers(0, 15, size=(ns, ss)).astype(np.int32)).to(device)
    clock = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(ns,)).astype(np.int32))
    valid = torch.from_numpy(rng.random((ns, ss)) > 0.3).to(device)
    return hits, clock.to(device), valid


def phase_flush(torch, seed: int, card: str) -> dict:
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(seed + 2)
    for ns, ss in FLUSH_GRID:
        hits, clock, valid = flush_inputs(torch, ns, ss, rng)
        out = ops.flush_scores(hits, clock, valid)
        torch.cuda.synchronize()
        same = bool(torch.equal(out, ref.flush_scores_ref(hits, clock, valid)))
        print(f"[kernels] flush_scores {ns} sets x {ss}: "
              f"{'equal to' if same else 'DIFFERS from'} the plain version", flush=True)
        check(same, f"flush_scores {ns} x {ss}: kernel differs from plain version")
    ns, ss = FLUSH_GRID[-1]
    hits, clock, valid = flush_inputs(torch, ns, ss, rng)
    kernel_ms = graph_ms(torch, lambda i: ops.flush_scores(hits, clock, valid), 20)
    plain_ms = graph_ms(torch, lambda i: ref.flush_scores_ref(hits, clock, valid), 3, reps=5)
    moved = ns * ss * (4 + 1 + 4) + ns * 4          # hits, valid, out; clock
    bw = hbm_bytes_per_s(card)
    print(f"[kernels] flush_scores at {ns} sets x {ss}: device time (CUDA graph replay) kernel "
          f"{kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, no library call, bound "
          f"{moved / bw * 1e6:.3f} us by bytes ({moved} B at {bw / 1e12:.2f} TB/s) on {card}",
          flush=True)
    del hits, clock, valid
    free_memory(torch)
    return {"cases": len(FLUSH_GRID), "max_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": moved / bw * 1e3, "bound_by": "bytes"}


# ---------------------------------------------------------------------------
# phase 4: exactness at full width under pool pressure
# ---------------------------------------------------------------------------

def dense_greedy(torch, T, params, cfg, prompt, n):
    """Greedy tokens of dense prefill + decode with plain attention: the
    plain flash version stands in ``ops`` for the kernel during prefill
    (dense decode has no kernel)."""
    from repro_torch.kernels import ops, ref

    toks = torch.tensor([prompt], device="cuda")
    kernel_fn = ops.flash_attention
    try:
        ops.flash_attention = ref.flash_attention_ref
        last, cache = T.prefill(params, toks, cfg, max_seq=128)
    finally:
        ops.flash_attention = kernel_fn
    out = []
    t = last[:, -1, :].argmax(-1)[:, None]
    for _ in range(n):
        out.append(int(t[0, 0]))
        lg, cache = T.decode_step(params, t, cache, cfg)
        t = lg[:, -1, :].argmax(-1)[:, None]
    return out


def phase_exact(torch, seed: int, kernels: dict) -> dict:
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
    zero_launches(kernels)
    eng.run(800)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    eng.close()
    st = eng.stats()
    print(f"[exact] qwen3-8b widths fp32, 2 layers, page 8, 4x3 sets, 6 requests: "
          f"stats {st}, launches {launches}", flush=True)
    check(all(eng.result(r).state == "done" for r in rids), "exact: a request did not finish")
    check(st["preemptions"] > 0 and st["offloads"] > 0 and st["fetches"] > 0,
          "exact: the pool-pressure path (preempt, offload, fetch) was not exercised")
    check(launches["paged_attention"] > 0,
          "exact: the engine did not launch the paged_attention kernel")
    check(launches["flash_attention"] == cfg.n_layers * len(prompts),
          f"exact: {launches['flash_attention']} flash launches for {len(prompts)} prefills")
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            want = dense_greedy(torch, T, params, cfg, p, 24)
            check(eng.result(rid).out == want, f"exact: request {rid} differs from dense "
                  f"decode: {eng.result(rid).out} vs {want}")
    print("[exact] engine tokens (flash + paged kernels) == tokens of prefill + decode with "
          "plain attention, for all 6 requests", flush=True)
    del params, eng
    free_memory(torch)
    return launches


def zero_launches(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0


def read_launches(kernels: dict) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


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


def full_model(torch, seed: int):
    """qwen3-8b at its published width and depth, bf16, random weights drawn
    on the card from ``seed``; phases 5 and 6 share them."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[serve] qwen3-8b bf16 {cfg.n_layers} layers d_model {cfg.d_model}: "
          f"{n_params / 1e9:.3f}B params drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, params


def phase_serve(torch, cfg, params, seed: int, kernels: dict, card: str) -> dict:
    from repro_torch.serving import ServeEngine

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
    zero_launches(kernels)
    t0 = time.perf_counter()
    eng.run(max_steps=5000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(kernels)
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
          f"{res['peak_gb']:.1f} GB, launches {launches} on {card}", flush=True)
    print(f"[serve] stats {eng.stats()} on {card}", flush=True)
    check(first["calls_ok"] and first["calls"] == cfg.n_layers,
          "serve: a kernel launch of the first decode step differs from the plain version")
    check(first["logits_rel_l2"] <= BF16_TOL,
          "serve: first-step logits with the kernel differ from those with plain attention")
    check(done == len(rids), f"serve: only {done}/{len(rids)} requests finished")
    check(launches["paged_attention"] == cfg.n_layers * res["decode_steps"],
          f"serve: {launches['paged_attention']} paged launches for {res['decode_steps']} "
          "decode steps")
    check(launches["flash_attention"] == cfg.n_layers * len(rids),
          f"serve: {launches['flash_attention']} flash launches for {len(rids)} prefills")
    res["profile"] = profile_steps(torch, eng, cfg, rng, res["median_step_ms"], card)
    eng.close()
    del eng, timed
    free_memory(torch)
    return res


# ---------------------------------------------------------------------------
# phase 6: prefill at full width and depth
# ---------------------------------------------------------------------------

class PrefillProbe:
    """Stands in for ``transformer.prefill`` while the engine runs.

    The first call holds each flash launch to the plain version on the same
    inputs and keeps its last-position logits; every call's time (to a
    synchronize) is kept."""

    def __init__(self, torch, prefill):
        self.torch, self.prefill, self.ms, self.first = torch, prefill, [], None

    def __call__(self, *args, **kw):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.first is not None:
            out = self.prefill(*args, **kw)
        else:
            kernel_fn, calls = ops.flash_attention, []

            def checked(q, k, v, **kw2):
                got = kernel_fn(q, k, v, **kw2)
                want = ref.flash_attention_ref(q, k, v, **kw2).float()
                calls.append(((got.float() - want).abs().max().item(), bool(torch.allclose(
                    got.float(), want, atol=BF16_TOL, rtol=BF16_TOL))))
                return got

            try:
                ops.flash_attention = checked
                out = self.prefill(*args, **kw)
            finally:
                ops.flash_attention = kernel_fn
            self.first = {"calls": len(calls), "calls_ok": all(ok for _, ok in calls),
                          "call_max_abs_err": max(e for e, _ in calls),
                          "logits": out[0].float().clone()}
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def phase_prefill(torch, cfg, params, seed: int, kernels: dict, card: str) -> dict:
    """Two 4,096-token prompts through the engine at full width and depth.
    The pool (32 sets x 12 pages of 16 tokens, the paper's set size) holds
    one such request at a time, so the second waits for the first to finish."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServeEngine

    page, num_sets, set_size = 16, 32, 12
    n_pages = PREFILL_TOKENS // page + 1      # the prompt and the next position
    eng = ServeEngine(cfg, params, max_batch=2, page_size=page, num_sets=num_sets,
                      set_size=set_size, max_pages=n_pages + 7, device="cuda")
    rng = np.random.default_rng(seed + 6)
    prompts = [[int(x) for x in rng.integers(1, cfg.vocab, PREFILL_TOKENS)] for _ in range(2)]
    # the reference: the first prompt's prefill with plain attention
    kernel_fn = ops.flash_attention
    with torch.no_grad():
        try:
            ops.flash_attention = ref.flash_attention_ref
            plain, _ = T.prefill(params, torch.tensor([prompts[0]], device="cuda"), cfg,
                                 max_seq=n_pages * page)
        finally:
            ops.flash_attention = kernel_fn
    plain = plain.float()
    free_memory(torch)

    probe = PrefillProbe(torch, T.prefill)
    rids = [eng.submit(p, max_new=PREFILL_NEW) for p in prompts]
    zero_launches(kernels)
    t0 = time.perf_counter()
    try:
        T.prefill = probe
        eng.run(max_steps=200)
    finally:
        T.prefill = probe.prefill
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(kernels)
    eng.close()
    first = probe.first
    got = first["logits"]
    rel_l2 = ((got - plain).norm() / plain.norm()).item()
    done = sum(eng.result(r).state == "done" for r in rids)
    res = {"requests": len(rids), "done": done, "prompt_tokens": PREFILL_TOKENS,
           "prefill_ms": probe.ms, "ttft_ms": probe.ms[-1], "seconds": dt,
           "launches": launches, "first_prefill": {k: v for k, v in first.items()
                                                   if k != "logits"},
           "logits_rel_l2": rel_l2, "logits_max_abs_err": (got - plain).abs().max().item(),
           "argmax_equal": bool(got.argmax() == plain.argmax()), "stats": eng.stats()}
    print(f"[prefill] first prefill: {first['calls']} flash launches vs plain version on the "
          f"same inputs max_abs_err {first['call_max_abs_err']:.3e} (tol {BF16_TOL:g}) "
          f"{'ok' if first['calls_ok'] else 'FAIL'}; last-position logits with the kernel vs a "
          f"plain-attention prefill: relative L2 {rel_l2:.3e} (tol {BF16_TOL:g}), max_abs_err "
          f"{res['logits_max_abs_err']:.3e}, argmax equal {res['argmax_equal']}", flush=True)
    print(f"[prefill] qwen3-8b bf16, {len(rids)} requests x {PREFILL_TOKENS}-token prompts, "
          f"{PREFILL_NEW} new tokens, page {page}, {num_sets} x {set_size} sets: {done}/"
          f"{len(rids)} done in {dt:.2f} s; prefill (time to first token once admitted) "
          f"{probe.ms[-1]:.1f} ms (first, with the checks: {probe.ms[0]:.1f} ms); launches "
          f"{launches}; stats {eng.stats()} on {card}", flush=True)
    check(first["calls_ok"] and first["calls"] == cfg.n_layers,
          "prefill: a flash launch of the first prefill differs from the plain version")
    check(rel_l2 <= BF16_TOL, "prefill: logits with the kernel differ from plain attention's")
    check(done == len(rids) and all(len(eng.result(r).out) == PREFILL_NEW for r in rids),
          f"prefill: only {done}/{len(rids)} requests finished")
    check(launches["flash_attention"] == cfg.n_layers * len(rids),
          f"prefill: {launches['flash_attention']} flash launches for {len(rids)} prefills")
    check(launches["paged_attention"] > 0, "prefill: no paged launch in the decode steps")
    del eng, probe, plain
    free_memory(torch)
    return res


# ---------------------------------------------------------------------------
# phase 7: the SA-cache twin
# ---------------------------------------------------------------------------

def phase_sa_cache(torch, seed: int, kernels: dict, card: str) -> dict:
    from repro_torch.core import sa_cache
    from repro_torch.launch import quickstart

    zero_launches(kernels)
    quickstart.main(["--device", "cuda"])
    rng = np.random.default_rng(seed + 7)
    ns, ss = FLUSH_GRID[-1]
    valid = rng.random((ns, ss)) > 0.2
    cpu = sa_cache.CacheState(
        tags=torch.from_numpy(np.where(valid, np.arange(ns * ss).reshape(ns, ss), -1)
                              .astype(np.int32)),
        hits=torch.from_numpy(rng.integers(0, sa_cache.MAX_HITS + 1, size=(ns, ss))
                              .astype(np.int32)),
        dirty=torch.from_numpy((rng.random((ns, ss)) > 0.4) & valid),
        clock=torch.from_numpy(rng.integers(0, ss, size=(ns,)).astype(np.int32)))
    card_state = sa_cache.CacheState(*(None if x is None else x.cuda() for x in cpu))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sa_cache.select_flush_candidates(card_state, 6, 2)   # paper: trigger 6, 1-2 per visit
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(kernels)
    want = sa_cache.select_flush_candidates(cpu, 6, 2)
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    print(f"[sa-cache] quickstart twin on the card ok; select_flush_candidates at {ns} sets x "
          f"{ss} (trigger 6, 2 per set): {int(want[0].sum())} sets to flush, card "
          f"{'==' if same else '!='} CPU, {card_ms:.2f} ms on the host clock; launches "
          f"{launches} on {card}", flush=True)
    check(same, "sa-cache: select_flush_candidates on the card differs from the CPU's")
    check(launches["flush_scores"] > 0, "sa-cache: the flush_scores kernel was not launched")
    return {"launches": launches, "equal": same, "select_ms": card_ms}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def build_all(torch, modules: dict) -> dict:
    """Build every kernel library at once, one nvcc each; print each one's
    time and its registers and spills."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    def build(mod):
        t0 = time.perf_counter()
        mod._kernel()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(modules)) as pool:
        seconds = dict(zip(modules, pool.map(build, modules.values())))
    for name, sec in seconds.items():
        print(f"[build] {name}.cu built and loaded in {sec:.1f} s", flush=True)
        for line in _build.build_logs.get(name, "(library already built)").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    return seconds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import flush_score as flush_mod
    from repro_torch.kernels import paged_attention as paged_mod

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(f"[device] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    kernels = {"paged_attention": paged_mod.paged_attention,
               "flash_attention": flash_mod.flash_attention,
               "flush_scores": flush_mod.flush_scores}

    try:
        # 2. build
        build_all(torch, {"paged_attention": paged_mod, "flash_attention": flash_mod,
                          "flush_score": flush_mod})
        # 3. kernels
        paged = phase_kernels(torch, args.seed, card)
        flash = phase_flash(torch, args.seed, card)
        flush = phase_flush(torch, args.seed, card)
        # 4-7. the paths
        exact = phase_exact(torch, args.seed, kernels)
        cfg, params = full_model(torch, args.seed)
        serve = phase_serve(torch, cfg, params, args.seed, kernels, card)
        prefill = phase_prefill(torch, cfg, params, args.seed, kernels, card)
        del params
        free_memory(torch)
        sa = phase_sa_cache(torch, args.seed, kernels, card)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    common = {"route": "cuda", "library_ms": None}
    line = {"kernels": [
        {**common, "name": "paged_attention",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:74",
         "launches": serve["launches"]["paged_attention"],
         "max_abs_err": max(paged["max_err_fp32"], paged["max_err_bf16"]),
         "ms": paged["ms"], "plain_ms": paged["plain_ms"], "bound_ms": paged["bound_ms"],
         "bound_by": paged["bound_by"], "library_ms": paged["library_ms"],
         "library": "page gather + scaled_dot_product_attention(enable_gqa=True)",
         "cases": paged["cases"], "max_err_fp32": paged["max_err_fp32"],
         "max_err_bf16": paged["max_err_bf16"], "eager_ms": paged["eager_ms"],
         "exact_phase_launches": exact["paged_attention"],
         "prefill_phase_launches": prefill["launches"]["paged_attention"]},
        {**common, "name": "flash_attention",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:84",
         "launches": prefill["launches"]["flash_attention"],
         "max_abs_err": max(flash["max_err_fp32"], flash["max_err_bf16"]),
         "ms": flash["ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
         "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
         "library": "scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
         "cases": flash["cases"], "max_err_fp32": flash["max_err_fp32"],
         "max_err_bf16": flash["max_err_bf16"],
         "serve_phase_launches": serve["launches"]["flash_attention"],
         "exact_phase_launches": exact["flash_attention"], "ttft_ms": prefill["ttft_ms"]},
        {**common, "name": "flush_scores",
         "source": "src/repro_torch/kernels/csrc/flush_score.cu",
         "replaces": "src/repro/kernels/flush_score.py:50",
         "launches": sa["launches"]["flush_scores"], "max_abs_err": flush["max_err"],
         "ms": flush["ms"], "plain_ms": flush["plain_ms"], "bound_ms": flush["bound_ms"],
         "bound_by": flush["bound_by"], "library": "none", "cases": flush["cases"]},
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": line["kernels"], "serve": serve, "prefill": prefill,
         "sa_cache": sa, "exact_launches": exact}, indent=1, default=str))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
