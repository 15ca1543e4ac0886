#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py [--seed N] [--decode-probe SRC | --flush-probe SRC |
                         --backward-probe SRC | --mesh-probe SRC]

Phases, each printing its own lines; any failure exits non-zero before the
last line:

  1. device   the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build    compile the four hand-written CUDA sources from ``src/``, one
              nvcc each, all at once (timed; registers and spills; fails if
              the wgmma flash kernel, a set-design flush kernel or any
              attention backward kernel spills);
  3. kernels  each kernel against its plain PyTorch version on the card:
              paged attention on the kernel tests' shapes, hd 120, the
              serving shape and the split-K plan's edges (lengths 0, 1, a
              split's last key, one past it, the table's end; fp32 2e-5,
              bf16 3e-2 elementwise, and relative L2 over the output fp32
              2e-5, bf16 1e-2; a length-0 row gives 0, two runs bitwise
              equal),
              then timed at the serving shape, decode-4k (B 4, 4,098-4,104
              keys) and decode-32k (B 1, 32,768 keys) beside a page gather +
              SDPA and the bound, with the plan's splits and blocks;
              paged attention also at olmoe's (H 16, KV 16, hd 128) and
              granite's (H 16, KV 8, hd 64) decode heads, with 3 and 6 splits;
              flash attention on the kernel tests' cases, the q_offset tail,
              hd 120 with window 4096, olmoe's and granite's prefill heads
              (S 512), whisper-tiny's encoder (1,500 x 1,500 frames, non-causal,
              hd 64) and cross-attention (4 queries over 1,500 keys),
              qwen2-vl-72b's prefill heads (S 1,088, group 8, hd 128; its decode
              heads for paged too), tinyllama-1.1b's training microbatch
              (4 x 2,048, H 32, KV 4, hd 64) and the wgmma kernel's edges (fp32
              2e-5, bf16 2e-2, each launched as the design it expects, two
              runs bitwise equal), then at qwen3-8b's prefill shape and
              gemma2's sliding layer (TFLOP/s, ratios to SDPA and to the
              bound); the attention backward kernel (``flash_attention_lse``
              forward, ``flash_attention_backward``) on ``FLASH_BWD_CASES`` at
              every head dim (16, 32, 64, 120, 128) in fp32 and bf16: causal,
              gemma2's window of 4,096 with softcap 50, ``q_offset``, a window
              narrower than a tile, Sq != Skv non-causal, rows with no valid
              key (zero dq), GQA 1, 2, 4 and 8, the wgmma tiles' edges (Skv
              ragged at 128 keys, Sq not a multiple of 64, GQA 8 with a
              q_offset), after the wgmma kernels' registers and spills from
              nvcc's report; dq, dk, dv held to
              ``ref.flash_attention_bwd`` (relative L2 fp32 2e-5, bf16 1e-2),
              the log-sum-exp to the plain one, each launched as the design
              it expects (``wgmma`` for bf16 at 64/120/128, else ``simt``), two
              runs bitwise equal; flush scores exactly equal on the kernel tests' grid,
              every set size of the set design (1-16) and the slot design's
              17, 64 and 256, blocks of 128 sets short, whole and past, views
              [1:] that are not 16-byte aligned, and 2,100 and 131,072 sets
              of 12, each set's inputs holding the int32 edges of the
              arithmetic, each launched as the design its set size takes;
              then timed at 131,072 and 1,048,576 sets of 12 with inputs and
              outputs rotated past the L2, and at 2,100 (launch-bound);
              times of each kernel, its plain version and a PyTorch library
              call, and the bound;
  4. exact    qwen3-8b, olmoe-1b-7b (capacity factor 1.25) and mamba2-780m
              at full width in fp32, depth cut to 2 layers, and reduced
              jamba-v0.1-52b: the serving engine (flash prefill, paged decode)
              under pool pressure must emit the greedy tokens of prefill +
              decode with plain attention, with preemptions, offloads and
              fetches all > 0 (for the mamba families, through the port's
              deviation: a preempted row's mamba state is kept); the MoE
              assignments dropped at capacity are counted, and olmoe also
              serves one 256-token prompt, whose prefill must drop some,
              with the same token check;
  5. serve    qwen3-8b at full width and depth in bf16 (random weights from
              --seed): 12 requests must all finish, with one flash launch per
              attention layer per request; the first decode step's logits
              with the kernel must match those with the plain version, each
              paged launch of that step too; tokens/s, the median decode
              step beside its bound by bytes, and the device's busy share
              under torch.profiler;
  6. prefill  the same model and weights: 3 requests of 4,096-token prompts
              through the engine (page 16, 32 x 12 sets); each flash launch
              of the first prefill held to the plain version and launched
              as wgmma, its logits to those of a plain-attention prefill;
              time to first token of the second; the third under
              torch.profiler: device time of flash, GEMMs, other elementwise
              work and page writes, and the device's busy share; each paged
              launch of the first decode step (4,097 keys) held to the
              plain version, the median decode step over the 4,097-4,104-key
              contexts, and the paged kernel's device time per step
              (torch.profiler, 3 steps);
  7. sa-cache the SA-cache twin: the quickstart twin on the card, and
              ``select_flush_candidates`` at 131,072 x 12 on the card equal
              to the CPU's, through one launch of the set design;
  8. families olmoe-1b-7b and mamba2-780m at full width and depth, and
              jamba-v0.1-52b at one block (8 layers) of its published width,
              bf16, random weights from --seed, one model at a time: the
              serve phase itself (4 requests for jamba), with its checks
              (paged and flash launches 0 for mamba2); the first step's MoE
              layers take the plain run's experts, and the expert sets the
              kernel run's router would have picked otherwise are counted;
  9. encdec   whisper-tiny at its published size, bf16, through the model API
     vision   (the engine serves no encoder-decoder model, nor does JAX's): 4
              clips of 1,500 random frames, a 4-token prefix, 64 greedy
              tokens; the first decode step held to one after a plain-attention
              prefill; encoder and prefill ms, the median step beside its bound
              by bytes, the busy share, all 12 flash launches wgmma; in fp32
              (simt) the kernel route's tokens equal the plain route's;
              qwen2-vl-72b at its published width, 24 of 80 layers (47.1 GB
              of bf16 weights), random weights from --seed: a prefill of
              1,024 random patch embeddings and 64 text tokens held to a
              plain-attention prefill, then the serve phase on text prompts
              (M-RoPE positions); at 2 layers in fp32, phase 4's exact check;
 10. train    the training path (``launch/steps.make_train_step``: forward
              with remat, chunked loss, AdamW; under ``ops.FlashAttention``
              the flash kernel forward and the attention backward kernel;
              ``ref.flash_attention_bwd`` runs on no CUDA tensor of phases
              10-11, counted): at full
              width and 2 layers in fp32 (whisper-tiny at full size) for
              tinyllama-1.1b, olmoe-1b-7b, mamba2-780m and whisper-tiny, one
              step's gradient (``make_grad_fn``, batch 4 x 512, 2
              microbatches) through the kernel and through the plain version: losses within 1e-5 relative, every
              gradient leaf within 1e-5 relative L2 and nonzero through the
              kernel, flash launches = attention calls x 2 (forward and the
              recompute) x microbatches, all simt, backward launches one an
              attention call and microbatch; tinyllama in bf16: 1e-2, 2e-2,
              all wgmma; ``remat="dots"`` (JAX's dots_saveable as a
              selective checkpoint) against remat=True for tinyllama at 2 fp32
              layers: every gradient leaf within 1e-5 relative L2, flash
              launched by the forward only; one attention call at tinyllama's training
              shape (4 x 2,048, bf16): the Function's output and dq, dk, dv
              held to the plain version's and its autograd's (2e-2, 1e-2
              relative L2); the backward kernel timed alone (CUDA graph) and
              its D, dK/dV and dQ kernels (torch.profiler) beside the plain
              version (``ref.flash_attention_bwd``), SDPA's backward and the
              bound, and the Function's backward as autograd runs it beside
              SDPA's (both eager); the same at qwen3-8b's training attention
              (1 x 4,096, H 32, KV 8, hd 128); then
              tinyllama-1.1b at its published size, bf16
              with an f32 master copy, 20 steps of batch 8 x 2,048 from
              SyntheticLM through the Prefetcher, a checkpoint at step 9 and at
              the end (save, wait and drain timed), the end's restored into
              fresh weights bitwise equal to the trained state, steps 10-19
              rerun from step 9's restore within 1e-3 relative; 880 backward
              launches in the 20 steps (22 layers x 2 microbatches x 20), all
              wgmma; the median
              step, tokens/s, the model-FLOP share, torch.profiler's busy share
              and device ms by flash forward, attention backward, GEMMs and
              optimizer, the peak memory; then 3 more steps under
              ``remat="dots"``: their median and peak beside remat=True's (the
              trained state is kept for phase 13);
 11. mesh     the distribution path on the one card, at world 1 (NCCL refuses
              two ranks on one device): an NCCL group of one over a FileStore
              under build/ and ``make_host_mesh``'s (1, 1) mesh; tinyllama-1.1b
              at its published size through ``make_train_step(cfg, mesh)``,
              params and optimizer state DTensors by ``param_specs``, batch
              8 x 2,048 by ``make_global_batch``, 2 microbatches, remat, 5
              steps on phase 10's weights and batches: the losses within
              1e-5 relative of phase 10's (bitwise or not printed), flash
              and backward launches through ``local_map`` = the unsharded
              route's counts,
              the median step beside phase 10's; the int8 error-feedback
              quantization of its gradient leaves equal to the CPU's (elements
              differing counted) and one compressed pass timed; olmoe-1b-7b
              (16 layers, bf16) served with every decode step the paged step's
              mesh route (``make_paged_decode_step(mesh=)``, the MoE and the
              paged kernel under ``local_map``), its first step's logits held
              to the unsharded step's (3e-2 relative L2, replayed routing),
              the median step beside phase 8's; qwen3-8b at its published size
              (bf16) through ``prefill(mesh=)`` and 16 greedy
              ``decode_step(mesh=)``s on the cache ``cache_specs`` places: the
              unsharded route's tokens, both medians; mamba2-780m's train step
              through ``mesh=`` (the Mamba2 scan under ``local_map`` on a rank's
              rows and heads), 3 steps of 4 x 512: losses within 1e-5 relative
              of the unsharded step's, both medians;
 12. tooling  the dry-run and cost tooling and the serving bench: (a)
              ``benchmarks/serving_bench.run`` with qwen3-8b at its published
              size, bf16, flusher on and then off (8 requests of 16 tokens,
              24 new, a pool of 4 sets x 3 pages of 8 tokens, so rows are
              preempted): every request finishes, both runs emit the same
              tokens, both preempt, the paged and flash kernels launched;
              blocking offloads, clean evictions, stale discards, offloads,
              fetches, tokens/s and the median step of each; (b)
              ``launch/cost.py`` over tinyllama-1.1b's train step at phase
              10's shape and qwen3-8b's paged decode step at phase 5's batch,
              on fake tensors on the card: FLOPs, bytes and the derived bound
              beside the medians phases 10 and 5 measured, the train count at
              least phase 10's model FLOPs and the decode count at least
              ``decode_step_bytes``; (c) ``launch/dryrun.py`` in a process of
              its own per cell, tinyllama-1.1b train_4k on the (16, 16) mesh,
              olmoe-1b-7b decode_32k on (2, 16, 16) (its argument bytes
              beside those of the cache with every row on every rank) and
              mamba2-780m train_4k on (16, 16), the card's route on this
              machine's torch: each exits 0, with its useful-FLOP ratio; and
              the host time the kernels' operator registration adds to a
              paged and a flash call;
 13. trace    the trace bridge into the SSD-array simulator: the port's
              ``run_fleet`` at ``FleetConfig()`` and --seed (rows,
              ``trace_digest``, seconds), and the trace that ``attach_ckpt``
              recorded of phase 10's final save of the trained state (one row
              a chunk, the digest, the save ms); both traces in
              ``build/traces/*.npz``;
 14. the kernels line (JSON), the device line, and the result line.

Each phase prints its seconds. The kernel launch counts are set to 0 just
before each run of phases 4-13 and read just after, to show each path ran
through its kernels.

With ``--decode-probe SRC`` it runs none of the phases: it takes the port
package under SRC (``src`` of this checkout or of an earlier commit) and
prints one JSON line with the paged wrapper's host time per call and phase
6's decode over 4,097+-key contexts (``decode_probe``), so the designs of
two commits can be compared in one run, say parent, change, change, parent.
``--flush-probe SRC`` does the same for the flush kernel (``flush_probe``):
its times at 131,072 and 1,048,576 sets of 12 rotated past the L2, and the
SASS of its library (``cuobjdump -sass``; the text beside the library).
``--backward-probe SRC`` does the same for the attention backward at
tinyllama's and qwen3-8b's training shapes (``time_attention_backward``: the
Function's output and gradients held to the plain version's, then timed; a package
without the backward kernel, as an earlier commit's, times the Function
and the plain version only).
``--mesh-probe SRC`` does the same for phase 11's timed runs at world 1
(``mesh_probe``): tinyllama's mesh train step, olmoe-1b-7b's mesh decode
step and qwen3-8b's dense decode unsharded and through ``mesh=``
(``mesh_decode``), with the batch constraints
(``transformer._constrain_batch``) each step makes and their host µs a call.

It needs a CUDA card, and exits non-zero when there is none. It imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

F32_TOL, BF16_TOL = 2e-5, 3e-2
# paged attention is also held to a relative L2 error over the whole output:
# with N(0,1) inputs its softmax is nearly flat, so outputs shrink as
# 1/sqrt(keys) (about 0.026 at 4,100 keys) and the absolute tolerance alone
# would pass a merge that dropped a split
PAGED_REL_L2_F32, PAGED_REL_L2_BF16 = 2e-5, 1e-2
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
SPLIT_CASES = [                           # 3+ splits on 132 SMs (tests/test_torch_cuda.py)
    (6, 4, 2, 16, 8, 12, 64),             # hd 16, pages shorter than a tile
    (6, 32, 8, 128, 16, 24, 160),         # qwen3-8b heads
    (6, 32, 8, 120, 16, 24, 160),         # h2o-danube heads (hd 120)
    (6, 32, 4, 64, 16, 24, 160),          # tinyllama heads (group 8)
    (6, 16, 1, 64, 16, 16, 40),           # group 16: two chunks of q heads
    (6, 4, 4, 32, 64, 6, 20),             # pages longer than a tile
    (6, 16, 16, 128, 16, 24, 160),        # olmoe-1b-7b heads (group 1): 3 splits
    (6, 16, 8, 64, 16, 24, 160),          # granite-moe-1b-a400m heads (group 2): 6 splits
    (6, 64, 8, 128, 16, 24, 160),         # qwen2-vl-72b heads (group 8 at hd 128)
]
FAMILY_PAGED_CASES = {                    # B 4, page 16: the families' decode heads
    "olmoe-decode": (4, 16, 16, 128, 16, 8, 64),
    "granite-decode": (4, 16, 8, 64, 16, 8, 64),
    "qwen2-vl-decode": (4, 64, 8, 128, 16, 8, 64),
}
SLICE_CASE = (4, 32, 8, 128, 16, 64, 65)  # qwen3-8b decode: B, H, KV, hd, page, max_pages, pool
PAGED_HEADS = (32, 8, 128, 16)            # qwen3-8b decode: H, KV, hd, page
PAGED_TIMED = {
    # name: table, pool pages, lengths, pool copies rotated
    "serve": (64, 65, [42, 52, 6, 59], 36),     # lengths like the serve phase's, a pool per layer
    "decode-4k": (264, 1056, [4098, 4104, 4098, 4103], 4),   # the prefill phase's contexts
    "decode-32k": (2048, 2048, [32768], 3),
}
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
    # the wgmma kernel's edges (tests/test_torch_cuda.py WGMMA_CASES)
    (1, 63, 1000, 4, 2, 128, True, 0, 0.0, 0),     # ragged against the 64- and 128-row tiles
    (1, 129, 65, 4, 2, 128, False, 0, 0.0, 0),
    (1, 1000, 127, 4, 2, 128, False, 0, 0.0, 0),
    (1, 1, 1000, 4, 2, 128, False, 0, 0.0, 0),
    (1, 127, 1000, 8, 2, 128, True, 0, 0.0, 873),  # q_offset tail
    (1, 1000, 1000, 4, 2, 128, True, 100, 0.0, 0),  # window not a multiple of the tile
    (1, 1000, 1000, 4, 2, 128, True, 0, 50.0, 0),   # softcap 50 (gemma2)
    (1, 130, 200, 4, 2, 128, True, 4, 0.0, 197),    # rows 6.. have no valid key: 0
    (1, 300, 300, 8, 1, 128, True, 0, 0.0, 0),      # GQA 8
    (3, 300, 300, 8, 4, 128, True, 0, 0.0, 0),      # B 3, GQA 2
    (2, 1000, 1000, 4, 2, 64, True, 100, 50.0, 0),  # hd 64
    (1, 1000, 1000, 4, 1, 120, True, 100, 0.0, 0),  # hd 120, GQA 4
    (1, 512, 512, 16, 16, 128, True, 0, 0.0, 0),    # olmoe-1b-7b prefill heads (group 1)
    (1, 512, 512, 16, 8, 64, True, 0, 0.0, 0),      # granite-moe-1b-a400m prefill heads
    (4, 1500, 1500, 6, 6, 64, False, 0, 0.0, 0),    # whisper-tiny encoder: ragged 128-key tail
    (4, 4, 1500, 6, 6, 64, False, 0, 0.0, 0),       # whisper-tiny cross-attention: 124 rows past Sq
    (1, 1088, 1088, 64, 8, 128, True, 0, 0.0, 0),   # qwen2-vl-72b vision prefill (group 8)
    (4, 2048, 2048, 32, 4, 64, True, 0, 0.0, 0),    # tinyllama-1.1b training microbatch
]
NO_KEY_CASE = (1, 130, 200, 4, 2, 128, True, 4, 0.0, 197)
WGMMA_HEAD_DIMS = (64, 120, 128)          # bf16 at these takes wgmma, forward and backward
FLASH_SLICE = (1, 4096, 32, 8, 128)       # qwen3-8b prefill: B, S, H, KV, hd (causal, bf16)
GEMMA2_SWA = (1, 8192, 32, 16, 128, 4096, 50.0)  # gemma2-27b sliding layer: ..., window, softcap
FLASH_BWD_CASES = [
    # b, sq, skv, h, kv, causal, window, softcap, q_offset: each at every FLASH_BWD_HEAD_DIMS
    (2, 300, 300, 8, 8, True, 0, 0.0, 0),          # causal, GQA 1
    (1, 4608, 4608, 4, 2, True, 4096, 50.0, 0),    # gemma2's window of 4,096, softcap 50; GQA 2
    (1, 127, 1000, 8, 2, True, 0, 0.0, 873),       # the q_offset tail, GQA 4
    (2, 64, 192, 8, 1, False, 0, 0.0, 0),          # Sq != Skv, non-causal, GQA 8
    (4, 4, 1500, 6, 6, False, 0, 0.0, 0),          # whisper-tiny's cross-attention
    (1, 130, 200, 4, 2, True, 4, 0.0, 197),        # rows 6.. have no valid key: zero dq
    (1, 100, 300, 4, 2, True, 20, 0.0, 150),       # a window narrower than a tile, q_offset
    (1, 1000, 1000, 4, 2, True, 100, 0.0, 0),      # a window not a multiple of a tile
    # the wgmma tiles' edges (tests/test_torch_flash_bwd.py)
    (1, 200, 200, 4, 2, True, 0, 0.0, 0),          # Skv ragged at the 128-key block, Sq at 64
    (2, 90, 330, 4, 2, False, 0, 0.0, 0),          # Sq 90 past a 64-query tile, Skv 330 ragged
    (1, 70, 260, 8, 1, True, 0, 0.0, 190),         # GQA 8 with a q_offset
]
FLASH_BWD_HEAD_DIMS = (16, 32, 64, 120, 128)
BWD_REL_L2 = {"float32": 2e-5, "bfloat16": 1e-2}   # dq, dk, dv against the plain version
LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-3}      # the forward's log-sum-exp, atol = rtol
FLUSH_GRID = [(100, 12), (1000, 12), (64, 7), (513, 16), (1, 12), (256, 2),   # tests
              (127, 12), (128, 12), (129, 12),   # a set-design block (128 sets) -1, 0, +1
              *[(1000, ss) for ss in range(1, 17)],  # every set-design instantiation
              (37, 17), (37, 64), (300, 256),    # the slot design
              (2100, 12),       # qwen3-8b's KV pool on an 80 GB card: 2.36 MB pages
              (131072, 12)]     # serving scale, 10^5+ sets (kernels/flush_score.py)
# hits[1:], clock[1:] and valid[1:] of (ns + 1, ss) tensors: not 16-byte
# aligned, so the set design stages them through shared memory
FLUSH_VIEWS = [(1000, 7), (1000, 12), (131072, 12), (300, 20)]
FLUSH_SET_MAX = 16                  # set sizes 1..16 take the set design, above it slot
FLUSH_TIMED = {
    # name: sets, set size, input and output copies rotated (each call HBM-fed)
    "131072x12": (131072, 12, 8),   # 8 x 14.7 MB, over twice the 50 MB L2
    "1048576x12": (1048576, 12, 1),  # 117 MB by itself
    "2100x12": (2100, 12, 1),        # qwen3-8b's pool on an 80 GB card: launch-bound
}
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
EXACT_FAMILIES = ("olmoe-1b-7b", "mamba2-780m", "jamba-v0.1-52b")   # phase 4 beside qwen3-8b
DROP_PROMPT = {"olmoe-1b-7b": 256}   # phase 4: a prompt whose prefill drops at capacity 1.25
PREFILL_TOKENS, PREFILL_NEW = 4096, 8
# phase 9: whisper-tiny transcribes 4 clips of 30 s (1,500 frames each) from a
# 4-token start-of-transcript prefix, 64 greedy tokens; qwen2-vl-72b at 24 of
# its 80 layers (47.1 GB of bf16 weights: all 80 need 145.4 GB) prefills
# 1,024 patch embeddings and 64 text tokens, then serves the serve traffic
WHISPER_CLIPS, WHISPER_PROMPT, WHISPER_NEW = 4, 4, 64
VISION_LAYERS, VISION_TEXT = 24, 64


class SmokeFailure(Exception):
    pass


PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall seconds printed and kept in ``PHASE_SECONDS``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        print(f"[time] {name}: {PHASE_SECONDS[name]:.1f} s", flush=True)


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


def paged_close(torch, out, want, tol: float, rel_tol: float) -> tuple[bool, float, float]:
    """(ok, max abs error, relative L2 error) of a paged-attention output:
    within ``tol`` elementwise (atol = rtol) and within ``rel_tol`` in
    relative L2 over the whole output."""
    out, want = out.float(), want.float()
    diff = out - want
    err = diff.abs().max().item()
    rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
    return bool(torch.allclose(out, want, atol=tol, rtol=tol)) and rel <= rel_tol, err, rel


def split_edge_lengths(case) -> list[int]:
    """0, 1, a split's last key, one past it, the table's end, and a row whose
    later splits lie wholly past its length, under this card's plan (also
    the card tests' cases, ``tests/test_torch_cuda.py``)."""
    from repro_torch.kernels import paged_attention as paged_mod

    b, h, kv, _, page, maxp, _ = case
    per, _ = paged_mod._plan_splits(b, kv, h // kv, maxp, page, paged_mod._sm_count(0))
    sk = per * page
    return [0, 1, sk, sk + 1, maxp * page, 2 * sk - 1][:b]


def phase_kernels(torch, seed: int, card: str) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as paged_mod

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
        for name, case in FAMILY_PAGED_CASES.items():
            cases.append((name, case, dtype, None, 0.0))
        for case in SPLIT_CASES:
            for cap in (0.0, 50.0):
                cases.append((f"split-edges{case} softcap {cap:g}", case, dtype,
                              split_edge_lengths(case), cap))
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rels = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, case, dtype, lengths, cap in cases:
        q, k, v, table, lens = paged_inputs(torch, case, dtype, rng, lengths)
        out = ops.paged_attention(q, k, v, table, lens, softcap=cap)
        plan = paged_mod.paged_attention.last_plan
        same = bool(torch.equal(out, ops.paged_attention(q, k, v, table, lens, softcap=cap)))
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(q, k, v, table, lens, softcap=cap)
        tol, rel_tol = ((F32_TOL, PAGED_REL_L2_F32) if dtype == torch.float32
                        else (BF16_TOL, PAGED_REL_L2_BF16))
        ok, err, rel = paged_close(torch, out, want, tol, rel_tol)
        zero_rows = (lens == 0).nonzero().flatten()
        if len(zero_rows):
            ok = ok and bool((out[zero_rows] == 0).all())
        errs[dtype] = max(errs[dtype], err)
        rels[dtype] = max(rels[dtype], rel)
        print(f"[kernels] paged_attention {name} {str(dtype)[6:]}: max_abs_err {err:.3e} "
              f"(tol {tol:g}), rel L2 {rel:.2e} (tol {rel_tol:g}), {plan['splits']} splits of {plan['pages_per_split']} pages, "
              f"rerun bitwise {'equal' if same else 'DIFFERENT'} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"paged_attention {name} {dtype}: kernel disagrees with plain version")
        check(same, f"paged_attention {name} {dtype}: two runs differ")

    timed = {name: time_paged(torch, card, rng, name, *shape)
             for name, shape in PAGED_TIMED.items()}
    return {"cases": len(cases), "max_err_fp32": errs[torch.float32],
            "max_err_bf16": errs[torch.bfloat16], "max_rel_l2_fp32": rels[torch.float32],
            "max_rel_l2_bf16": rels[torch.bfloat16], "timed": timed}


def timed_paged_inputs(torch, rng, maxp: int, pool: int, lengths: list[int], copies: int):
    """q, ``copies`` K and V pools, table and lengths at qwen3-8b's decode
    heads (H 32, KV 8, hd 128, page 16, bf16). A table of ``b * maxp <=
    pool`` entries is a permutation of the pool, so every key is a distinct
    row of memory."""
    h, kv, hd, page = PAGED_HEADS
    b = len(lengths)
    ids = (rng.permutation(pool)[:b * maxp] if b * maxp <= pool
           else rng.integers(0, pool, size=b * maxp))
    table = torch.from_numpy(ids.reshape(b, maxp).astype(np.int32)).to("cuda")
    lens = torch.from_numpy(np.asarray(lengths, np.int32)).to("cuda")
    q = torch.randn((b, h, hd), device="cuda").to(torch.bfloat16)
    kpools = torch.randn((copies, pool, page, kv, hd), device="cuda").to(torch.bfloat16)
    vpools = torch.randn((copies, pool, page, kv, hd), device="cuda").to(torch.bfloat16)
    return q, kpools, vpools, table, lens


def wrapper_host_us(torch, fn) -> float:
    """Median host time of one call of ``fn`` (the wrapper's Python, the
    allocations and the launches; no synchronize inside the timed call, one
    after every 8 calls so the launch queue never fills)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    spent = []
    for _ in range(60):
        for _ in range(8):
            t0 = time.perf_counter()
            fn()
            spent.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(spent) * 1e6


def time_paged(torch, card: str, rng, name: str, maxp: int, pool: int, lengths: list[int],
               copies: int) -> dict:
    """Device time of the paged kernel at qwen3-8b's decode heads (H 32, KV 8,
    hd 128, page 16, bf16) beside its plain version, a page gather + SDPA and
    the bound by bytes. ``copies`` pools are rotated so that the K/V the
    timed calls read exceeds the 50 MB L2 (at the serving shape, a pool per
    layer). The kernel is first held to the plain version (3e-2 elementwise
    and 1e-2 relative L2), twice, bitwise equal. Also the wrapper's host
    time per call."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as paged_mod

    h, kv, hd, page = PAGED_HEADS
    lens_np = np.asarray(lengths)
    b = len(lengths)
    q, kpools, vpools, table, lens = timed_paged_inputs(torch, rng, maxp, pool, lengths, copies)

    out = ops.paged_attention(q, kpools[0], vpools[0], table, lens)
    plan = dict(paged_mod.paged_attention.last_plan)
    again = ops.paged_attention(q, kpools[0], vpools[0], table, lens)
    want = ref.paged_attention_ref(q, kpools[0], vpools[0], table, lens)
    ok, err, rel = paged_close(torch, out, want, BF16_TOL, PAGED_REL_L2_BF16)
    same = bool(torch.equal(out, again))
    print(f"[kernels] paged_attention {name}: max_abs_err {err:.3e} (tol {BF16_TOL:g}; "
          f"max |plain| {want.float().abs().max().item():.3e}), rel L2 {rel:.2e} (tol "
          f"{PAGED_REL_L2_BF16:g}), rerun bitwise {'equal' if same else 'DIFFERENT'}, plan {plan} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"paged_attention {name}: kernel disagrees with plain version")
    check(same, f"paged_attention {name}: two runs differ")
    if maxp >= 256:
        check(plan["blocks"] >= 2 * paged_mod._sm_count(0),
              f"paged_attention {name}: the plan launches only {plan['blocks']} blocks")
    del out, again, want

    calls = max(copies, 4)

    def kernel(i):
        return ops.paged_attention(q, kpools[i % copies], vpools[i % copies], table, lens)

    kernel_ms = graph_ms(torch, kernel, calls)
    eager_ms = time_ms(torch, kernel, 10 * calls)
    host_us = wrapper_host_us(torch, lambda: kernel(0))
    plain_ms = graph_ms(torch, lambda i: ref.paged_attention_ref(
        q, kpools[i % copies], vpools[i % copies], table, lens), min(calls, 4), reps=5)
    # library yardstick: gather the pages the longest row needs, then SDPA
    n_pages = -(-int(lens_np.max()) // page)
    s_ctx = n_pages * page
    idx = table[:, :n_pages].long()
    mask = (torch.arange(s_ctx, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qs = q[:, :, None, :]

    def library(i):
        kc = kpools[i % copies][idx].reshape(b, s_ctx, kv, hd).transpose(1, 2)
        vc = vpools[i % copies][idx].reshape(b, s_ctx, kv, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask, enable_gqa=True)

    library_ms = graph_ms(torch, library, min(calls, 4), reps=5)
    lib_err = (library(0)[:, :, 0].float()
               - ref.paged_attention_ref(q, kpools[0], vpools[0], table, lens).float()
               ).abs().max().item()
    work = paged_mod.cost(tuple(q.shape), tuple(kpools[0].shape), tuple(table.shape), 2,
                          lengths)
    moved, flops = work["bytes"], work["flops"]
    bw = hbm_bytes_per_s(card)
    bound_s = max(moved / bw, flops / BF16_PEAK_FLOPS)
    bound_by = "bytes" if moved / bw >= flops / BF16_PEAK_FLOPS else "operations"
    print(f"[kernels] paged_attention {name} at B{b} H{h} KV{kv} hd{hd} page{page} bf16, table "
          f"{maxp}, lengths {lens_np.tolist()}: device time (CUDA graph replay) kernel "
          f"{kernel_ms * 1e3:.2f} us (eager, host launch included: {eager_ms * 1e3:.2f} us; "
          f"host time in the wrapper {host_us:.2f} us), "
          f"plain {plain_ms * 1e3:.2f} us, gather+sdpa {library_ms * 1e3:.2f} us (err vs plain "
          f"{lib_err:.2e}), bound {bound_s * 1e6:.3f} us by {bound_by} ({moved} B at "
          f"{bw / 1e12:.2f} TB/s); kernel / bound {kernel_ms / (bound_s * 1e3):.2f}x, kernel / "
          f"gather+sdpa {kernel_ms / library_ms:.2f}x on {card}", flush=True)
    del kpools, vpools
    free_memory(torch)
    return {"ms": kernel_ms, "eager_ms": eager_ms, "wrapper_host_us": host_us,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bytes": moved, "lengths": lens_np.tolist(), "table": maxp, "plan": plan,
            "max_abs_err": err, "rel_l2": rel}


def phase_flash(torch, seed: int, card: str) -> dict:
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(seed + 1)
    by_design = flash_mod.flash_attention.launches_by_design
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
            kind = "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "simt"
            before = by_design[kind]
            out = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            launched = by_design[kind] - before
            same = bool(torch.equal(out, ops.flash_attention(q, k, v, **kw)))
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = (out.float() - want.float()).abs().max().item()
            ok = bool(torch.allclose(out.float(), want.float(), atol=tol, rtol=tol))
            if case == NO_KEY_CASE:
                ok = ok and bool((out[:, 6:] == 0).all())
            errs[dtype] = max(errs[dtype], err)
            n += 1
            print(f"[kernels] flash_attention {case} {str(dtype)[6:]} ({kind}): max_abs_err "
                  f"{err:.3e} (tol {tol:g}), rerun bitwise {'equal' if same else 'DIFFERENT'} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"flash_attention {case} {dtype}: kernel disagrees with plain version")
            check(launched == 1, f"flash_attention {case} {dtype}: not launched as {kind}")
            check(same, f"flash_attention {case} {dtype}: two runs differ")
            del q, k, v, out, want
            free_memory(torch)

    slice_t = time_flash(torch, card, FLASH_SLICE, window=0, softcap=0.0, with_plain=True)
    swa = time_flash(torch, card, GEMMA2_SWA[:5], window=GEMMA2_SWA[5], softcap=GEMMA2_SWA[6],
                     with_plain=False)
    return {"cases": n, "max_err_fp32": errs[torch.float32],
            "max_err_bf16": errs[torch.bfloat16], **slice_t, "gemma2_swa": swa}


def time_flash(torch, card: str, shape, *, window: int, softcap: float, with_plain: bool) -> dict:
    """Device time of the flash kernel at one causal bf16 prefill shape,
    beside its bound and PyTorch's fused SDPA on (B, H, S, hd) (with the
    window as a mask; SDPA has no softcap), and, at S 4096, the plain
    version. The kernel is first held to the plain version on 4 q heads."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops, ref

    b, s, h, kv, hd = shape
    q, k, v = (torch.randn(sh, device="cuda").to(torch.bfloat16)
               for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    kw = dict(causal=True, window=window, softcap=softcap)
    rep = h // kv
    out = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q[:, :, :2 * rep].contiguous(), k[:, :, :2].contiguous(),
                                   v[:, :, :2].contiguous(), **kw)
    err = (out[:, :, :2 * rep].float() - want.float()).abs().max().item()
    check(bool(torch.allclose(out[:, :, :2 * rep].float(), want.float(), atol=FLASH_BF16_TOL,
                              rtol=FLASH_BF16_TOL)),
          f"flash_attention at {shape} window {window}: kernel disagrees with plain version")
    del out, want
    kernel_ms = graph_ms(torch, lambda i: ops.flash_attention(q, k, v, **kw), 3, reps=5)
    plain_ms = (graph_ms(torch, lambda i: ref.flash_attention_ref(q, k, v, **kw), 1, reps=3)
                if with_plain else None)
    qt = q.transpose(1, 2).contiguous()
    if window:
        # SDPA's flash backend takes no mask: the window goes in as a boolean
        # mask over K/V expanded to every q head
        kt, vt = (x.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous() for x in (k, v))
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        library = lambda i: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        library_name = "scaled_dot_product_attention(attn_mask=causal window), no softcap"
    else:
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        library = lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                           enable_gqa=True)
        library_name = "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
    library_ms = graph_ms(torch, library, 3, reps=5)
    work = flash_mod.cost(tuple(q.shape), tuple(k.shape), 2, causal=True, window=window)
    flops, moved = work["flops"], work["bytes"]
    bw = hbm_bytes_per_s(card)
    bound_s = max(moved / bw, flops / BF16_PEAK_FLOPS)
    bound_by = "bytes" if moved / bw >= flops / BF16_PEAK_FLOPS else "operations"
    tflops = flops / kernel_ms / 1e9
    print(f"[kernels] flash_attention at B{b} S{s} H{h} KV{kv} hd{hd} causal window {window} "
          f"softcap {softcap:g} bf16 (wgmma): device time (CUDA graph replay) kernel "
          f"{kernel_ms:.4f} ms = {tflops:.1f} TFLOP/s, "
          f"plain {'%.3f ms' % plain_ms if plain_ms else 'not timed'}, sdpa {library_ms:.4f} ms "
          f"(kernel / sdpa {kernel_ms / library_ms:.2f}x), bound {bound_s * 1e3:.4f} ms by "
          f"{bound_by} ({flops:.4e} FLOP at {BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s; {moved} B) "
          f"(kernel / bound {kernel_ms / (bound_s * 1e3):.2f}x); plain vs kernel on 4 q heads "
          f"max_abs_err {err:.3e} on {card}", flush=True)
    del q, k, v, qt, kt, vt
    free_memory(torch)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": library_name, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "flops": flops, "tflops": tflops, "shape": [b, s, h, kv, hd], "window": window,
            "softcap": softcap}


def phase_flash_bwd(torch, seed: int, card: str) -> dict:
    """The attention backward kernel against its plain version: for each of
    ``FLASH_BWD_CASES`` at every head dim, fp32 and bf16, the forward kernel's
    output and log-sum-exp (``flash_attention_lse``; the lse held to
    ``ref.flash_attention_lse``'s, +inf where a row has no valid key), then
    ``flash_attention_backward`` twice (bitwise equal, launched as the design
    the input takes) against ``ref.flash_attention_bwd`` on the same inputs
    and output (``BWD_REL_L2``); rows with no valid key get a zero dq. First
    the registers and spills of the wgmma design's kernels from nvcc's
    report."""
    import repro_torch.kernels.ops  # registers torch.ops.repro_torch.*  # noqa: F401
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention_bwd as bwd_mod
    from repro_torch.kernels import ref

    wgmma = {}
    for fn, r in ptxas_report(_build.build_logs.get("flash_attention_bwd", "")).items():
        m = re.search(r"wg\d+(dkv|dq)_kernelILi(\d+)E", fn)
        if m:
            wgmma[f"{m.group(1)}<{m.group(2)}>"] = r
    print("[kernels] flash_attention_bwd wgmma kernels (nvcc -Xptxas -v; <64> at hd 64, <128> "
          "at hd 120 and 128): " + ", ".join(
              f"{n} {r.get('registers')} registers, {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes of spill stores / loads"
              for n, r in sorted(wgmma.items())),
          flush=True)
    check(len(wgmma) == 4, f"flash_attention_bwd: {sorted(wgmma)} in nvcc's report, not the "
          "wgmma dkv and dq kernels at 64 and 128 columns")

    rng = np.random.default_rng(seed + 3)
    by_design = bwd_mod.flash_attention_bwd.launches_by_design
    ops = torch.ops.repro_torch
    errs, rels, n = {}, {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        errs[name] = rels[name] = 0.0
        for case in FLASH_BWD_CASES:
            for hd in FLASH_BWD_HEAD_DIMS:
                b, sq, skv, h, kv, causal, window, cap, q_offset = case
                q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                               .to("cuda", dtype) for shape in
                               ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd), (b, sq, h, hd)))
                args = (causal, window, cap, q_offset)
                kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
                kind = "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "simt"
                out, lse = ops.flash_attention_lse(q, k, v, *args)
                before = by_design[kind]
                grads = ops.flash_attention_backward(q, k, v, out, lse, do, *args)
                again = ops.flash_attention_backward(q, k, v, out, lse, do, *args)
                torch.cuda.synchronize()
                launched = by_design[kind] - before
                same = all(torch.equal(x, y) for x, y in zip(grads, again))
                wants = ref.flash_attention_bwd(q, k, v, out, do, **kw)
                rel = max(rel_l2(g, w) for g, w in zip(grads, wants))
                err = max((g.float() - w.float()).abs().max().item() for g, w in zip(grads, wants))
                want_lse = ref.flash_attention_lse(q, k, v, **kw)[1]
                empty = torch.isinf(want_lse)
                lse_ok = (bool(torch.equal(torch.isinf(lse), empty))
                          and bool(torch.allclose(lse[~empty], want_lse[~empty],
                                                  atol=LSE_TOL[name], rtol=LSE_TOL[name])))
                rows_empty = empty[0, 0]                 # the masks are the same for every head
                zero_dq = bool((grads[0][:, rows_empty] == 0).all())
                ok = rel <= BWD_REL_L2[name] and lse_ok and zero_dq
                errs[name] = max(errs[name], err)
                rels[name] = max(rels[name], rel)
                n += 1
                print(f"[kernels] flash_attention_bwd {case} hd {hd} {name} ({kind}): rel L2 "
                      f"{rel:.2e} (tol {BWD_REL_L2[name]:g}), max_abs_err {err:.3e}, lse "
                      f"{'ok' if lse_ok else 'DIFFERENT'}, {int(rows_empty.sum())} rows with no "
                      f"key{' (zero dq)' if zero_dq else ' GET A DQ'}, rerun bitwise "
                      f"{'equal' if same else 'DIFFERENT'} {'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"flash_attention_bwd {case} hd {hd} {dtype}: kernel disagrees with "
                      "the plain version")
                check(launched == 2, f"flash_attention_bwd {case} hd {hd} {dtype}: not launched "
                      f"as {kind}")
                check(same, f"flash_attention_bwd {case} hd {hd} {dtype}: two runs differ")
                del q, k, v, do, out, lse, grads, again, wants
                free_memory(torch)
    return {"cases": n, "max_err_fp32": errs["float32"], "max_err_bf16": errs["bfloat16"],
            "max_rel_l2_fp32": rels["float32"], "max_rel_l2_bf16": rels["bfloat16"],
            "wgmma_ptxas": wgmma}


def flush_inputs(torch, ns: int, ss: int, rng, device="cuda"):
    hits = torch.from_numpy(rng.integers(0, 15, size=(ns, ss)).astype(np.int32)).to(device)
    clock = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(ns,)).astype(np.int32))
    valid = torch.from_numpy(rng.random((ns, ss)) > 0.3).to(device)
    return hits, clock.to(device), valid


def flush_edge_arrays(ns: int, ss: int, rng) -> tuple:
    """numpy inputs of the flush scores, (hits (ns, ss) int32, clock (ns,)
    int32, valid (ns, ss) bool), whose first and last sets hold the edges of
    the int32 arithmetic: clocks at INT32_MIN, INT32_MIN+1 .. INT32_MIN+ss,
    -1, 0 and INT32_MAX; hits where hits * ss wraps, hits at INT32_MAX, at
    INT32_MIN and negative; a set with no valid slot; a valid slot whose d
    is INT32_MAX, tied with the empty slots; and, at odd ss, a set whose d
    are all equal under the wrap (at even ss the parity of d is that of the
    slot's distance, so they cannot be). The sets between are random over
    the whole int32 range, half of them with hits 0-14, 70 % valid."""
    every = np.ones(ss, bool)

    def small():
        return rng.integers(0, 15, size=ss)

    def anywhere():
        return int(rng.integers(INT32_MIN, INT32_MAX + 1))

    edges = [(small(), c, every) for c in
             (INT32_MIN, *range(INT32_MIN + 1, INT32_MIN + ss + 1), -1, 0, INT32_MAX)]
    edges += [(2 ** 31 // ss + rng.integers(-2, 3, size=ss), anywhere(), every),
              (np.full(ss, INT32_MAX), anywhere(), every),
              (np.full(ss, INT32_MIN), anywhere(), every),
              (rng.integers(INT32_MIN, 0, size=ss), anywhere(), every),
              (small(), anywhere(), np.zeros(ss, bool))]
    k = ss // 2      # d = (INT32_MAX // ss) * ss + INT32_MAX % ss = INT32_MAX at slot k
    hits, valid = small(), rng.random(ss) > 0.5
    hits[k], valid[k] = INT32_MAX // ss, True
    edges.append((hits, k - INT32_MAX % ss, valid))
    if ss % 2:       # hits = (d - dist) / ss mod 2**32 gives every slot the same d
        clock, d = anywhere(), int(rng.integers(0, 2 ** 32))
        dist = [((((slot - clock) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000) % ss
                for slot in range(ss)]
        edges.append((np.array([(d - x) * pow(ss, -1, 2 ** 32) % 2 ** 32 for x in dist]),
                      clock, every))
    hits = np.where(rng.random((ns, 1)) < 0.5, rng.integers(0, 15, size=(ns, ss)),
                    rng.integers(INT32_MIN, INT32_MAX + 1, size=(ns, ss)))
    clock = rng.integers(INT32_MIN, INT32_MAX + 1, size=ns)
    valid = rng.random((ns, ss)) > 0.3
    for i, (h, c, v) in enumerate(edges[:ns]):
        for row in (i, ns - 1 - i):
            hits[row], clock[row], valid[row] = h, c, v
    return hits.astype(np.int32), clock.astype(np.int32), valid


def flush_case(torch, ns: int, ss: int, rng, view: bool = False, device="cuda"):
    """``flush_edge_arrays`` as tensors; with ``view``, hits[1:], clock[1:]
    and valid[1:] of tensors one set longer, which are not 16-byte aligned."""
    n = ns + 1 if view else ns
    hits, clock, valid = (torch.from_numpy(a).to(device) for a in flush_edge_arrays(n, ss, rng))
    return (hits[1:], clock[1:], valid[1:]) if view else (hits, clock, valid)


def phase_flush(torch, seed: int, card: str) -> dict:
    from repro_torch.kernels import flush_score as flush_mod
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(seed + 2)
    by_design = flush_mod.flush_scores.launches_by_design
    cases = [(ns, ss, False) for ns, ss in FLUSH_GRID] + [(ns, ss, True) for ns, ss in FLUSH_VIEWS]
    for ns, ss, view in cases:
        hits, clock, valid = flush_case(torch, ns, ss, rng, view)
        kind = "set" if ss <= FLUSH_SET_MAX else "slot"
        before = dict(by_design)
        out = ops.flush_scores(hits, clock, valid)
        torch.cuda.synchronize()
        made = {d: by_design[d] - before[d] for d in before}
        same = bool(torch.equal(out, ref.flush_scores_ref(hits, clock, valid)))
        what = (f"flush_scores {ns} sets x {ss}{' (views [1:])' if view else ''}, int32 edges "
                f"({kind})")
        print(f"[kernels] {what}: {'equal to' if same else 'DIFFERS from'} the plain version, "
              f"launches {made}", flush=True)
        check(same, f"{what}: kernel differs from plain version")
        check(made == {d: int(d == kind) for d in made}, f"{what}: not launched as {kind}")
        del hits, clock, valid, out
    timed = {name: time_flush(torch, card, rng, *shape) for name, shape in FLUSH_TIMED.items()}
    return {"cases": len(cases), "max_err": 0.0, **timed["131072x12"], "shapes": timed}


def time_flush(torch, card: str, rng, ns: int, ss: int, copies: int) -> dict:
    """Device time of the flush kernel at ``ns`` sets x ``ss`` (CUDA-graph
    replay), ``copies`` inputs and outputs rotated so that each call reads
    and writes device memory, not the L2; the same on views of the inputs
    (hits[1:], clock[1:], valid[1:], which the set design stages through
    shared memory); the plain version and the bound by bytes. The kernel is
    first held to the plain version on both, exactly."""
    from repro_torch.kernels import flush_score as flush_mod
    from repro_torch.kernels import ops, ref

    ins = [flush_inputs(torch, ns + 1, ss, rng) for _ in range(copies)]
    aligned = [tuple(x[:-1] for x in t) for t in ins]
    views = [tuple(x[1:] for x in t) for t in ins]
    for args, what in ((aligned[0], "aligned"), (views[0], "views [1:]")):
        check(bool(torch.equal(ops.flush_scores(*args), ref.flush_scores_ref(*args))),
              f"flush_scores {ns} x {ss} ({what}): kernel differs from plain version")
    keep = []

    def timed(call, args):
        keep.clear()
        ms = graph_ms(torch, lambda i: keep.append(call(*args[i % copies])), max(2 * copies, 4))
        keep.clear()
        return ms

    kernel_ms = timed(ops.flush_scores, aligned)
    view_ms = timed(ops.flush_scores, views)
    plain_ms = graph_ms(torch, lambda i: ref.flush_scores_ref(*aligned[i % copies]),
                        min(copies, 3), reps=5)
    moved = flush_mod.cost(ns, ss)["bytes"]
    bw = hbm_bytes_per_s(card)
    bound_ms = moved / bw * 1e3
    print(f"[kernels] flush_scores at {ns} sets x {ss}, {copies} copies rotated: device time "
          f"(CUDA graph replay) kernel {kernel_ms * 1e3:.3f} us (views [1:]: "
          f"{view_ms * 1e3:.3f} us), plain "
          f"{plain_ms * 1e3:.2f} us, no library call, bound {bound_ms * 1e3:.3f} us by bytes "
          f"({moved} B at {bw / 1e12:.2f} TB/s); kernel / bound {kernel_ms / bound_ms:.2f}x "
          f"on {card}", flush=True)
    del ins, aligned, views
    free_memory(torch)
    return {"ms": kernel_ms, "view_ms": view_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": "bytes", "bytes": moved,
            "copies": copies, "shape": [ns, ss]}


def sass_report(lib: Path) -> tuple[dict, str]:
    """Per kernel of a built library, from ``cuobjdump -sass``: its SASS
    instructions (NOPs left out) and each loop (a branch back to an earlier
    address) with the instructions of its body. Also the SASS text."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None and not m.group(2).startswith("NOP"):
            cur.append((int(m.group(1), 16), m.group(2)))
    report = {}
    for name, ins in funcs.items():
        loops = []
        for addr, op in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) <= addr:
                top = int(m.group(1), 16)
                loops.append({"top": hex(top), "branch": hex(addr),
                              "instructions": sum(top <= a <= addr for a, _ in ins)})
        report[name] = {"instructions": len(ins), "loops": loops}
    return report, text


def flush_probe(torch, seed: int, card: str) -> dict:
    """``--flush-probe SRC``: the flush kernel of the port package under SRC
    (this checkout's, or an earlier commit's unpacked beside it), so two
    designs can be compared in one run on one card: ``time_flush`` at
    131,072 and 1,048,576 sets x 12, rotated past the L2, and the SASS of
    its library (the text beside it, as ``<library>.sass``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flush_score as flush_mod

    flush_mod._kernel()
    lib = Path(_build._loaded["flush_score"]._name)
    sass, text = sass_report(lib)
    lib.with_suffix(".sass").write_text(text)
    rng = np.random.default_rng(seed + 8)
    return {"flush_module": flush_mod.__file__, "card": card, "library": lib.name,
            "sass": sass, **{name: time_flush(torch, card, rng, *FLUSH_TIMED[name])
                             for name in ("131072x12", "1048576x12")}}


# ---------------------------------------------------------------------------
# phase 4: exactness at full width under pool pressure
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def flash_stand_in(make):
    """``make(kernel_fn)`` stands in ``ops`` for the flash kernel."""
    from repro_torch.kernels import ops

    kernel_fn = ops.flash_attention
    ops.flash_attention = make(kernel_fn)
    try:
        yield
    finally:
        ops.flash_attention = kernel_fn


def plain_flash():
    """The plain flash version (f32 math) stands in for the kernel."""
    from repro_torch.kernels import ref

    return flash_stand_in(lambda _: ref.flash_attention_ref)


def jax_route_flash():
    """The JAX model's own attention at these lengths stands in for the
    kernel: ``layers._dense_attention``, which rounds the softmax weights to
    V's dtype as JAX's does (the plain flash version keeps them in f32)."""
    from repro_torch.models import layers as L

    def dense(q, k, v, *, causal, window, softcap, q_offset=0):
        return L._dense_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                  q_offset=q_offset)

    return flash_stand_in(lambda _: dense)


def checked_flash(torch, calls: list):
    """The kernel with each launch held to the plain version on the same
    inputs (3e-2 elementwise): appends (max abs error, ok) to ``calls``."""
    from repro_torch.kernels import ref

    def make(kernel_fn):
        def checked(q, k, v, **kw):
            got = kernel_fn(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            calls.append(((got.float() - want).abs().max().item(),
                          bool(torch.allclose(got.float(), want, atol=BF16_TOL, rtol=BF16_TOL))))
            return got
        return checked

    return flash_stand_in(make)


def greedy_tokens(torch, T, params, cfg, toks, n: int, *, plain: bool, max_seq: int, **kw):
    """Greedy tokens (B lists of ``n``) of prefill + decode from ``toks``
    (B, S), with the plain flash version in the kernel's place during
    prefill when ``plain`` (dense decode has no kernel); ``kw`` goes to
    prefill (``enc_frames``)."""
    with torch.no_grad():
        with plain_flash() if plain else contextlib.nullcontext():
            last, cache = T.prefill(params, toks, cfg, max_seq=max_seq, **kw)
        out = []
        t = last[:, -1, :].argmax(-1)[:, None]
        for _ in range(n):
            out.append(t)
            lg, cache = T.decode_step(params, t, cache, cfg)
            t = lg[:, -1, :].argmax(-1)[:, None]
    return torch.cat(out, dim=1).tolist()


def dense_greedy(torch, T, params, cfg, prompt, n):
    """Greedy tokens of dense prefill + decode of one prompt with plain
    attention."""
    return greedy_tokens(torch, T, params, cfg, torch.tensor([prompt], device="cuda"), n,
                         plain=True, max_seq=max(128, len(prompt) + n))[0]


def attn_layers(cfg) -> int:
    return cfg.n_blocks * sum(spec.kind == "attn" for spec in cfg.block)


def exact_config(arch: str):
    """Phase 4's configuration of ``arch``: the published width in fp32 with
    the depth cut to 2 layers (olmoe at its published capacity factor,
    1.25), or, for jamba, the reduced config (2 blocks of 8 layers)."""
    from repro_torch.configs import get_config, reduced

    if arch == "jamba-v0.1-52b":
        return reduced(get_config(arch))
    return dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")


@contextlib.contextmanager
def counting_drops(drops: list):
    """Appends the MoE assignments each dispatch drops at capacity."""
    from repro_torch.models import moe

    dispatch_fn = moe.dispatch

    def dispatch(idx, n_experts, cap):
        keep, dest = dispatch_fn(idx, n_experts, cap)
        drops.append(int((~keep).sum()))
        return keep, dest

    moe.dispatch = dispatch
    try:
        yield
    finally:
        moe.dispatch = dispatch_fn


def exact_run(torch, cfg, params, kernels: dict, arch: str, prompts: list, max_new: int,
              sets: tuple[int, int]) -> tuple[dict, dict, int]:
    """The engine (page 8, ``sets`` = (sets, set size)) serves ``prompts``;
    each request's tokens must be the greedy tokens of prefill + decode with
    plain attention. Returns the launches and stats of the engine's run and
    the MoE assignments it dropped at capacity."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=sets[0],
                      set_size=sets[1], device="cuda")
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    drops = []
    zero_launches(kernels)
    with counting_drops(drops):
        eng.run(800)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    eng.close()
    st = eng.stats()
    what = (f"{arch} widths" if arch != "jamba-v0.1-52b" else f"{arch} reduced "
            f"(d_model {cfg.d_model})")
    print(f"[exact] {what} fp32, {cfg.n_layers} layers, page 8, {sets[0]}x{sets[1]} sets, "
          f"{len(prompts)} requests (prompts of {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens): stats {st}, launches {launches}, MoE assignments dropped at capacity "
          f"{sum(drops)} (of {len(drops)} dispatches)", flush=True)
    check(all(eng.result(r).state == "done" for r in rids),
          f"exact {arch}: a request did not finish")
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            want = dense_greedy(torch, T, params, cfg, p, max_new)
            check(eng.result(rid).out == want, f"exact {arch}: request {rid} differs from "
                  f"dense decode: {eng.result(rid).out} vs {want}")
    print(f"[exact] {arch}: engine tokens (flash + paged kernels) == tokens of prefill + "
          f"decode with plain attention, for all {len(prompts)} requests, under "
          f"{st['preemptions']} preemptions", flush=True)
    return launches, st, sum(drops)


def phase_exact(torch, seed: int, kernels: dict, arch: str = "qwen3-8b") -> dict:
    """The engine under pool pressure (page 8, 4 x 3 sets, 6 requests of 24
    new tokens) emits the greedy tokens of prefill + decode with plain
    attention. For the mamba families that equality is the port's deviation
    from the reference: the engine keeps a preempted row's mamba state. For
    olmoe at capacity 1.25 one ``DROP_PROMPT`` prompt (32 x 4 sets, no
    pressure) must drop assignments in its prefill and still match."""
    from repro_torch.models import transformer as T

    cfg = exact_config(arch)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 250, int(rng.integers(3, 20)))]
               for _ in range(6)]
    launches, st, drops = exact_run(torch, cfg, params, kernels, arch, prompts, 24, (4, 3))
    n_attn = attn_layers(cfg)
    check(st["preemptions"] > 0 and st["offloads"] > 0 and st["fetches"] > 0,
          f"exact {arch}: the pool-pressure path (preempt, offload, fetch) was not exercised")
    check((launches["paged_attention"] > 0) == (n_attn > 0),
          f"exact {arch}: {launches['paged_attention']} paged_attention launches for "
          f"{n_attn} attention layers")
    check(launches["flash_attention"] == n_attn * len(prompts),
          f"exact {arch}: {launches['flash_attention']} flash launches for {len(prompts)} "
          "prefills")
    launches = {**launches, "moe_dropped": drops}
    if arch in DROP_PROMPT:
        long_prompt = [int(x) for x in rng.integers(1, 250, DROP_PROMPT[arch])]
        _, _, long_drops = exact_run(torch, cfg, params, kernels, arch, [long_prompt], 8,
                                     (32, 4))
        check(long_drops > 0, f"exact {arch}: the {len(long_prompt)}-token prompt dropped "
              f"no MoE assignment at capacity factor {cfg.moe_capacity_factor}")
        launches["moe_dropped_long_prompt"] = long_drops
    del params
    free_memory(torch)
    return launches


def zero_launches(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0
        if hasattr(fn, "combine_launches"):
            fn.combine_launches = fn.splits = 0
        if hasattr(fn, "launches_by_design"):
            fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)


def read_launches(kernels: dict) -> dict:
    counts = {name: fn.launches for name, fn in kernels.items()}
    fn = kernels["paged_attention"]
    counts.update(paged_combine=fn.combine_launches, paged_splits=fn.splits)
    return counts


def read_designs(kernels: dict) -> dict:
    return {name: dict(fn.launches_by_design) for name, fn in kernels.items()
            if hasattr(fn, "launches_by_design")}


# ---------------------------------------------------------------------------
# phase 5: serve at full width and depth
# ---------------------------------------------------------------------------

def checked_paged(torch, kernel_fn, calls: list):
    """``kernel_fn`` with each call held to the plain version on the same
    inputs (3e-2 elementwise, 1e-2 relative L2): appends (max abs error,
    relative L2, ok) to ``calls``."""
    from repro_torch.kernels import ref

    def checked(*a, **kw):
        out = kernel_fn(*a, **kw)
        ok, err, rel = paged_close(torch, out, ref.paged_attention_ref(*a, **kw), BF16_TOL,
                                   PAGED_REL_L2_BF16)
        calls.append((err, rel, ok))
        return out

    return checked


def checked_summary(calls: list) -> dict:
    return {"calls": len(calls), "calls_ok": all(ok for _, _, ok in calls),
            "call_max_abs_err": max((e for e, _, _ in calls), default=0.0),
            "call_max_rel_l2": max((r for _, r, _ in calls), default=0.0)}


class TimedStep:
    """Wraps the engine's decode step and times each call (to a synchronize).

    The first call runs the step twice on the same inputs: once with the
    plain attention in the kernel's place, for the logits, then with the
    kernel, holding each of its launches to the plain version on the same
    inputs. The mamba state the first run writes is put back before the
    second (the K/V writes are the same both times). The kernel run's MoE
    layers take the plain run's experts and weights, so that its logits
    differ by the attention's error alone; the (token, layer) expert sets
    its own router would have picked otherwise are counted (``route_flips``).
    Its output is the kernel run's; it is not timed. With ``reference``,
    the first run is that step (phase 11: the unsharded step, with the
    kernel) in place of the plain-attention run."""

    def __init__(self, torch, step_fn, reference=None):
        self.torch, self.step_fn, self.ms, self.first = torch, step_fn, [], None
        self.reference = reference    # the first call's reference run, else plain attention

    def _first_step(self, args):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels import paged_attention as paged_mod
        from repro_torch.models import moe
        kernel_fn, route_fn = ops.paged_attention, moe.route
        calls, routes, plain_routes = [], ([], []), []
        states = [(a, a.clone()) for pool in args[1] for name, a in pool.items()
                  if name not in ("k", "v")]

        def recorded(run):
            def route(*a, **kw):
                out = route_fn(*a, **kw)
                routes[run].append(out[1].sort(dim=-1).values)
                if run == 0:
                    plain_routes.append(out)
                    return out
                w, idx, _ = plain_routes[len(routes[1]) - 1]
                return w, idx, out[2]
            return route

        try:
            if self.reference is None:
                ops.paged_attention = ref.paged_attention_ref
            moe.route = recorded(0)
            counted = paged_mod.paged_attention
            counts = (counted.launches, counted.combine_launches, counted.splits)
            plain = (self.reference or self.step_fn)(*args)
            # the reference's own launches are a comparison's, not the path's
            counted.launches, counted.combine_launches, counted.splits = counts
            for a, saved in states:
                a.copy_(saved)
            del states
            ops.paged_attention = checked_paged(torch, kernel_fn, calls)
            moe.route = recorded(1)
            got = self.step_fn(*args)
        finally:
            ops.paged_attention, moe.route = kernel_fn, route_fn
        # (token, MoE layer) pairs whose top-k expert set differs between the runs
        flips = sum(int((a != b).any(-1).sum()) for a, b in zip(*routes))
        self.first = {
            **checked_summary(calls), "lengths": args[3].tolist(),
            "active_rows": int(args[5].numel()),
            "routes": sum(len(a) for a in routes[0]), "route_flips": flips,
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


def profiled_device_ms(torch, run, calls: int) -> dict:
    """Device time per call of ``run`` by kernel name: ``calls`` calls under
    torch.profiler, ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 / calls
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}


def kernel_ms_per_launch(torch, run, parts: tuple, calls: int = 10) -> dict:
    """Device ms a launch of the kernels whose names hold ``<part>_kernel``,
    over ``calls`` calls of ``run`` under torch.profiler: each one's device
    time over the launches the profiler recorded, which can be fewer than
    the calls made."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    out = {}
    for part in parts:
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and f"{part}_kernel" in e.key]
        n = sum(e.count for e in evs)
        ms = sum(getattr(e, "self_device_time_total", 0.0) for e in evs) / 1e3
        out[part] = ms / n if n else 0.0
    return out


def profile_steps(torch, eng, cfg, rng, median_step_ms: float, card: str) -> dict:
    """torch.profiler over 5 decode steps of 4 fresh requests (admitted and
    prefilled before the window): device time per step by kernel, and the
    device's busy share of an unprofiled step (the main run's median)."""
    for _ in range(4):
        eng.submit([int(x) for x in rng.integers(1, cfg.vocab, 16)], max_new=8)
    eng.step()                                   # admission + prefill, outside the window
    steps = 5
    dev_ms = profiled_device_ms(torch, eng.step, steps)
    eng.run(max_steps=100)
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


def decode_step_bytes(cfg, params, eng, lengths: list[int], active: int) -> dict:
    """Bytes a decode step of the engine must move, each read or write once:
    every weight (the capacity design computes every expert's buffer, so
    every expert's weights are read; of an untied embedding only the B rows
    gathered), the mamba state of the B rows read and of the active rows
    written, the K/V of ``lengths + 1`` keys of each row read and one key of
    each active row written per attention layer, and the f32 logits."""
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.tree import leaves

    b = len(lengths)
    elem = 2 if cfg.dtype == "bfloat16" else 4
    weights = sum(x.numel() * x.element_size() for x in leaves(params))
    if not cfg.tie_embeddings:
        weights -= (params["embed"].shape[0] - b) * cfg.d_model * elem
    per_row = sum(a[:, 0].numel() * a.element_size()
                  for i in eng._mamba_positions for a in eng.pools[i].values())
    key = paged_mod.kv_bytes([1], cfg.n_kv_heads, cfg.head_dim, elem)    # K and V of one key
    kv = attn_layers(cfg) * (paged_mod.kv_bytes([n + 1 for n in lengths], cfg.n_kv_heads,
                                                cfg.head_dim, elem) + key * active)
    return {"weights": weights, "state": per_row * (b + active), "kv": kv,
            "logits": b * cfg.vocab * 4}


def load_model(torch, arch: str, seed: int, layers: int | None = None, tag: str = "[serve]"):
    """``arch`` at its published width and depth (or its first ``layers``
    layers), bf16, random weights drawn on the card from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    cfg = full = get_config(arch)
    if layers:
        cfg = dataclasses.replace(full, n_layers=layers)
        print(f"{tag} {arch}: depth cut to {layers} of {full.n_layers} layers at the published "
              f"width: all {full.n_layers} need "
              f"{full.param_count() * 2 / 1e9:.1f} GB of bf16 weights, beyond one 80 GB card",
              flush=True)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    drawn = leaves(params)
    print(f"{tag} {arch} bf16 {cfg.n_layers} layers d_model {cfg.d_model}: "
          f"{sum(x.numel() for x in drawn) / 1e9:.3f}B params "
          f"({sum(x.numel() * x.element_size() for x in drawn) / 1e9:.2f} GB) drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, params


def phase_serve(torch, cfg, params, seed: int, kernels: dict, card: str, n_req: int = 12,
                tag: str = "[serve]", mesh=None) -> dict:
    """``n_req`` requests (prompts of 4-47 tokens, 24 new tokens) through the
    engine at batch 4, page 16, 16 x 4 sets. The first decode step is held to
    plain attention (each paged launch and the logits, ``TimedStep``);
    tokens/s, the median step beside its bound by bytes, the launches, and
    the device's busy share under torch.profiler.

    With a ``mesh`` (phase 11) every decode step is the mesh route of the
    paged step (``make_paged_decode_step(mesh=)``, the params DTensors in the
    serving layout), and its first step is held to the engine's own
    unsharded step, with the kernel, on the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import leaves

    eng = ServeEngine(cfg, params, max_batch=4, page_size=16, num_sets=16, set_size=4,
                      device="cuda")
    if mesh is None:
        timed = TimedStep(torch, eng.step_fn)
    else:
        from repro_torch.distributed import distribute_tree, param_specs
        from repro_torch.serving.paged_model import make_paged_decode_step

        dparams = distribute_tree(params, param_specs(params, mesh, fsdp=False), mesh)
        mesh_step = make_paged_decode_step(cfg, page_size=16, mesh=mesh)
        timed = TimedStep(torch, lambda _, *a: mesh_step(dparams, *a), reference=eng.step_fn)
    eng.step_fn = timed
    rng = np.random.default_rng(seed)
    rids = []
    for _ in range(n_req):
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
    n_attn = attn_layers(cfg)
    moved = decode_step_bytes(cfg, params, eng, first["lengths"], first["active_rows"])
    bw = hbm_bytes_per_s(card)
    bound_ms = sum(moved.values()) / bw * 1e3
    median = statistics.median(timed.ms)
    res = {"layers": cfg.n_layers, "published_layers": get_config(cfg.name).n_layers,
           "params": sum(x.numel() for x in leaves(params)), "requests": n_req,
           "done": done, "tokens": toks, "seconds": dt, "tokens_per_s": toks / dt,
           "decode_steps": len(timed.ms) + 1, "median_step_ms": median,
           "step_bound_ms": bound_ms, "step_bytes": moved, "first_step": first,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "stats": eng.stats(), "card": card}
    print(f"{tag} first decode step: {first['calls']} paged launches vs plain version on the "
          f"same inputs max_abs_err {first['call_max_abs_err']:.3e} (tol {BF16_TOL:g}), rel L2 "
          f"{first['call_max_rel_l2']:.2e} (tol {PAGED_REL_L2_BF16:g}) "
          f"{'ok' if first['calls_ok'] else 'FAIL'}; logits "
          f"{'of the mesh route vs the unsharded step' if mesh else 'with kernel vs with plain attention'}: "
          f"max_abs_err {first['logits_max_abs_err']:.3e}, relative L2 {first['logits_rel_l2']:.3e} "
          f"(tol {BF16_TOL:g}), argmax equal in {first['argmax_equal_rows']}/{first['rows']} rows"
          + (f"; the kernel run's own router would pick another top-{cfg.moe_topk} set in "
             f"{first['route_flips']} of {first['routes']} (token, layer) pairs"
             if cfg.moe_experts else ""), flush=True)
    print(f"{tag} {done}/{n_req} done, {toks} tokens in {dt:.2f} s: "
          f"{res['tokens_per_s']:.1f} tokens/s, median decode step {median:.2f} ms over "
          f"{res['decode_steps']} steps; step bound {bound_ms:.3f} ms by bytes ("
          f"{', '.join(f'{k} {v / 1e9:.4f} GB' for k, v in moved.items())} at "
          f"{bw / 1e12:.2f} TB/s; first step's lengths {first['lengths']}); peak "
          f"{res['peak_gb']:.1f} GB, launches {launches} on {card}", flush=True)
    print(f"{tag} stats {eng.stats()} on {card}", flush=True)
    check(first["calls_ok"] and first["calls"] == n_attn,
          f"{tag}: a paged launch of the first decode step differs from the plain version, "
          f"or {first['calls']} launches for {n_attn} attention layers")
    check(first["logits_rel_l2"] <= BF16_TOL,
          f"{tag}: first-step logits with the kernel differ from those with plain attention")
    check(done == n_req, f"{tag}: only {done}/{n_req} requests finished")
    check(launches["paged_attention"] == n_attn * res["decode_steps"],
          f"{tag}: {launches['paged_attention']} paged launches for {res['decode_steps']} "
          "decode steps")
    check(launches["flash_attention"] == n_attn * n_req,
          f"{tag}: {launches['flash_attention']} flash launches for {n_req} prefills")
    check(n_attn == 0 or launches["paged_combine"] > 0,
          f"{tag}: the paged combine kernel was not launched")
    res["profile"] = profile_steps(torch, eng, cfg, rng, median, card)
    eng.close()
    del eng, timed
    free_memory(torch)
    return res


# ---------------------------------------------------------------------------
# phase 8: the MoE, Mamba2 and hybrid families at full width
# ---------------------------------------------------------------------------

FAMILY_SERVE = {
    # arch: (layers kept, requests); the serve phase's traffic otherwise
    "olmoe-1b-7b": (None, 12),
    "mamba2-780m": (None, 12),
    "jamba-v0.1-52b": (8, 4),    # one block of its 8-layer period at the published width
}


def phase_families(torch, seed: int, kernels: dict, card: str) -> dict:
    """The serve phase for olmoe-1b-7b and mamba2-780m at their published
    width and depth, and jamba-v0.1-52b at one block of its published width
    (4 requests), bf16, one model freed before the next loads."""
    results = {}
    for arch, (layers, n_req) in FAMILY_SERVE.items():
        cfg, params = load_model(torch, arch, seed, layers, tag="[families]")
        results[arch] = phase_serve(torch, cfg, params, seed, kernels, card, n_req,
                                    tag=f"[families] {arch}")
        del params
        free_memory(torch)
    return results


# ---------------------------------------------------------------------------
# phase 9: the encoder-decoder and vision families
# ---------------------------------------------------------------------------

def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def whisper_inputs(torch, cfg, seed: int):
    """4 clips of random encoder frames (1,500 each, f32: the encoder casts
    them to the config dtype) and a random 4-token decoder prefix, drawn on
    the card from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    frames = torch.randn((WHISPER_CLIPS, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device="cuda")
    prompt = torch.randint(0, cfg.vocab, (WHISPER_CLIPS, WHISPER_PROMPT), generator=gen,
                           device="cuda")
    return frames, prompt


def encdec_step_bytes(cfg, params, lengths: list[int]) -> dict:
    """Bytes a whisper decode step must move, each once: the decoder's
    weights (of an untied embedding only the B rows gathered; not the
    encoder's, nor the cross K/V projections, spent in prefill), the self
    K/V of ``lengths + 1`` keys read and one key written per layer, every
    layer's cross K/V (``encoder_seq`` keys a row) and the f32 logits."""
    from repro_torch.tree import leaves

    b = len(lengths)
    elem = 2 if cfg.dtype == "bfloat16" else 4
    spent = {id(params["blocks"][0]["cross"][w]) for w in ("wk", "wv")}
    decoder = {k: v for k, v in params.items() if k != "encoder"}
    weights = sum(x.numel() * x.element_size() for x in leaves(decoder) if id(x) not in spent)
    if not cfg.tie_embeddings:
        weights -= (params["embed"].shape[0] - b) * cfg.d_model * elem
    key = cfg.n_kv_heads * cfg.head_dim * 2 * elem                   # K and V of one key
    return {"weights": weights, "self_kv": cfg.n_layers * key * (sum(n + 1 for n in lengths) + b),
            "cross_kv": cfg.n_layers * key * b * cfg.encoder_seq, "logits": b * cfg.vocab * 4}


def phase_whisper(torch, seed: int, kernels: dict, card: str) -> dict:
    """whisper-tiny at its published size in bf16 through the model API
    (``prefill(enc_frames=)``, then ``decode_step``; no engine serves an
    encoder-decoder model): 4 clips, a 4-token prefix, 64 greedy tokens.
    The first decode step's logits are held to the same step after a
    plain-attention prefill, on the same token. The encoder's time, the
    time to first token, the median decode step beside its bound by bytes,
    the flash launches by design, and the device's busy share of a step."""
    from repro_torch.models import transformer as T

    cfg, params = load_model(torch, "whisper-tiny", seed, tag="[encdec]")
    frames, prompt = whisper_inputs(torch, cfg, seed)
    max_seq = WHISPER_PROMPT + WHISPER_NEW + 8          # and the profiler's 5 steps
    n_flash = cfg.encoder_layers + 2 * cfg.n_layers      # encoder, then self and cross
    with torch.no_grad():
        with plain_flash():
            plain_last, cache = T.prefill(params, prompt, cfg, max_seq, enc_frames=frames)
        tok = plain_last[:, -1].argmax(-1)[:, None]
        plain_step = T.decode_step(params, tok, cache, cfg)[0].float()
        last, cache = T.prefill(params, prompt, cfg, max_seq, enc_frames=frames)
        step = T.decode_step(params, tok, cache, cfg)[0].float()
        prefill_rel, step_rel = rel_l2(last, plain_last), rel_l2(step, plain_step)
        argmax_rows = int((step.argmax(-1) == plain_step.argmax(-1)).sum())
        del cache, plain_last, plain_step
        free_memory(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T._encoder_forward(params, frames, cfg)
        torch.cuda.synchronize()
        encoder_ms = (time.perf_counter() - t0) * 1e3

        # the main path: prefill, then greedy decode steps, each to a synchronize
        zero_launches(kernels)
        t0 = time.perf_counter()
        last, cache = T.prefill(params, prompt, cfg, max_seq, enc_frames=frames)
        t = last[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out, step_ms = [t], []
        for _ in range(WHISPER_NEW - 1):
            t0 = time.perf_counter()
            lg, cache = T.decode_step(params, t, cache, cfg)
            t = lg[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            out.append(t)
        launches, designs = read_launches(kernels), read_designs(kernels)
        finite = bool(torch.isfinite(lg).all())
        tokens = torch.cat(out, dim=1)
        state = {"t": t, "cache": cache}

        def one_step():
            lg, state["cache"] = T.decode_step(params, state["t"], state["cache"], cfg)
            state["t"] = lg[:, -1].argmax(-1)[:, None]

        dev_ms = profiled_device_ms(torch, one_step, 5)
    median = statistics.median(step_ms)
    mid = WHISPER_PROMPT + WHISPER_NEW // 2
    moved = encdec_step_bytes(cfg, params, [mid] * WHISPER_CLIPS)
    bw = hbm_bytes_per_s(card)
    bound_ms = sum(moved.values()) / bw * 1e3
    busy = sum(dev_ms.values())
    gemm = sum(ms for k, ms in dev_ms.items() if any(g in k for g in ("gemm", "nvjet", "cutlass")))
    res = {"clips": WHISPER_CLIPS, "prompt_tokens": WHISPER_PROMPT, "tokens": tokens.numel(),
           "encoder_ms": encoder_ms, "prefill_ms": prefill_ms, "decode_steps": len(step_ms),
           "median_step_ms": median, "step_bound_ms": bound_ms, "step_bytes": moved,
           "tokens_per_s": tokens.numel() / (prefill_ms + sum(step_ms)) * 1e3,
           "device_ms_per_step": busy, "gemm_ms_per_step": gemm,
           "busy_share_of_median_step": busy / median if busy else None,
           "first_step_logits_rel_l2": step_rel, "prefill_logits_rel_l2": prefill_rel,
           "first_step_argmax_equal_rows": argmax_rows, "launches": launches,
           "launches_by_design": designs, "card": card}
    print(f"[encdec] whisper-tiny bf16, {WHISPER_CLIPS} clips x {cfg.encoder_seq} frames, "
          f"{WHISPER_PROMPT}-token prefix: first decode step's logits after a kernel prefill vs "
          f"a plain-attention one, same token: relative L2 {step_rel:.3e} (tol {BF16_TOL:g}), "
          f"argmax equal in {argmax_rows}/{WHISPER_CLIPS} rows; prefill logits relative L2 "
          f"{prefill_rel:.3e}", flush=True)
    print(f"[encdec] encoder {encoder_ms:.2f} ms, prefill (time to first token) {prefill_ms:.2f} "
          f"ms, {len(step_ms)} decode steps median {median:.3f} ms, step bound {bound_ms * 1e3:.2f} "
          f"us by bytes ({', '.join(f'{k} {v / 1e6:.2f} MB' for k, v in moved.items())} at "
          f"{bw / 1e12:.2f} TB/s); {res['tokens_per_s']:.1f} tokens/s; device busy "
          + (f"{busy:.3f} ms a step (GEMM {gemm:.3f}) = "
             f"{100 * res['busy_share_of_median_step']:.1f} % of the median step"
             if busy else "not measured (the profiler recorded no device time)")
          + f"; launches {launches} {designs} on {card}", flush=True)
    check(step_rel <= BF16_TOL, "encdec: whisper's first-step logits with the kernel differ "
          "from those after a plain-attention prefill")
    check(launches["flash_attention"] == n_flash and designs["flash_attention"] ==
          {"simt": 0, "wgmma": n_flash}, f"encdec: whisper's prefill launched flash "
          f"{designs['flash_attention']}, not {n_flash} wgmma")
    check(launches["paged_attention"] == 0, "encdec: whisper ran the paged kernel")
    check(finite and tokens.shape == (WHISPER_CLIPS, WHISPER_NEW)
          and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
          "encdec: whisper's logits are not finite or its tokens out of range")
    del params, cache, state
    free_memory(torch)
    return res


def phase_whisper_exact(torch, seed: int, kernels: dict) -> dict:
    """whisper-tiny at its published size in fp32 (``simt`` flash): the
    kernel route's 64 greedy tokens of each clip equal the plain route's."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("whisper-tiny"), dtype="float32")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    frames, prompt = whisper_inputs(torch, cfg, seed)
    kw = dict(max_seq=WHISPER_PROMPT + WHISPER_NEW, enc_frames=frames)
    n_flash = cfg.encoder_layers + 2 * cfg.n_layers
    zero_launches(kernels)
    got = greedy_tokens(torch, T, params, cfg, prompt, WHISPER_NEW, plain=False, **kw)
    launches, designs = read_launches(kernels), read_designs(kernels)
    want = greedy_tokens(torch, T, params, cfg, prompt, WHISPER_NEW, plain=True, **kw)
    same = sum(g == w for g, w in zip(got, want))
    print(f"[exact] whisper-tiny fp32, {WHISPER_CLIPS} clips, {WHISPER_NEW} greedy tokens: kernel "
          f"route == plain route in {same}/{WHISPER_CLIPS} clips; launches {launches} {designs}",
          flush=True)
    check(same == WHISPER_CLIPS, "exact whisper-tiny: the kernel route's tokens differ from the "
          f"plain route's: {got} vs {want}")
    check(designs["flash_attention"] == {"simt": n_flash, "wgmma": 0},
          f"exact whisper-tiny: flash launches {designs['flash_attention']}, not {n_flash} simt")
    del params
    free_memory(torch)
    return launches


def phase_vision(torch, seed: int, kernels: dict, card: str) -> dict:
    """qwen2-vl-72b at its published width, 24 of 80 layers, bf16: one
    prefill of 1,024 random patch embeddings and 64 text tokens, then the
    serve phase on text prompts under the default M-RoPE positions.

    The prefill is checked twice. Each flash launch is held to the plain
    version on the same inputs (3e-2 elementwise). The last logits are held
    to a plain-attention prefill (f32 softmax weights) within 3e-2 relative
    L2, or, where bf16 alone parts further at this depth, within the
    distance of the JAX model's own attention route (``jax_route_flash``:
    weights rounded to bf16) from that same plain prefill, measured in this
    run: the kernel may not be further from plain attention than the
    reference's own bf16 attention is. Then the time to first token and the
    flash launches by design of an unchecked prefill."""
    from repro_torch.models import transformer as T

    cfg, params = load_model(torch, "qwen2-vl-72b", seed, VISION_LAYERS, tag="[vision]")
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    nv = cfg.vis_tokens
    vis = torch.randn((1, nv, cfg.d_model), generator=gen, device="cuda")
    toks = torch.cat([torch.zeros((1, nv), dtype=torch.long, device="cuda"),   # replaced by vis
                      torch.randint(1, cfg.vocab, (1, VISION_TEXT), generator=gen, device="cuda")],
                     dim=1)
    s = toks.shape[1]
    calls = []
    with torch.no_grad():
        with plain_flash():
            plain, _ = T.prefill(params, toks, cfg, s + 1, vis_embeds=vis)
        with jax_route_flash():
            jax_route, _ = T.prefill(params, toks, cfg, s + 1, vis_embeds=vis)
        with checked_flash(torch, calls):                  # also the warm-up
            T.prefill(params, toks, cfg, s + 1, vis_embeds=vis)
        free_memory(torch)
        zero_launches(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, _ = T.prefill(params, toks, cfg, s + 1, vis_embeds=vis)
        torch.cuda.synchronize()
        ttft = (time.perf_counter() - t0) * 1e3
        launches, designs = read_launches(kernels), read_designs(kernels)
    err, floor = rel_l2(last, plain), rel_l2(jax_route, plain)
    limit = max(BF16_TOL, floor)
    prefill = {"patches": nv, "text_tokens": VISION_TEXT, "ttft_ms": ttft,
               "logits_rel_l2": err, "jax_route_rel_l2": floor, "logits_limit": limit,
               "argmax_equal": bool(last.argmax() == plain.argmax()),
               "checked_calls": len(calls), "checked_calls_ok": all(ok for _, ok in calls),
               "call_max_abs_err": max(e for e, _ in calls),
               "launches": launches, "launches_by_design": designs, "card": card}
    print(f"[vision] qwen2-vl-72b bf16 {cfg.n_layers} layers, prefill of {nv} patch embeddings + "
          f"{VISION_TEXT} text tokens (S {s}): {len(calls)} flash launches vs plain version on the "
          f"same inputs max_abs_err {prefill['call_max_abs_err']:.3e} (tol {BF16_TOL:g}) "
          f"{'ok' if prefill['checked_calls_ok'] else 'FAIL'}; last logits vs a plain-attention "
          f"prefill relative L2 {err:.3e} (the JAX route's bf16 attention vs the same: "
          f"{floor:.3e}; limit {limit:.3e}), argmax equal {prefill['argmax_equal']}; time to "
          f"first token {ttft:.1f} ms; launches {launches} {designs} on {card}", flush=True)
    check(prefill["checked_calls_ok"] and len(calls) == cfg.n_layers,
          "vision: a flash launch of the prefill differs from the plain version")
    check(err <= limit, "vision: prefill logits with the kernel differ from plain attention's "
          "by more than the JAX route's own bf16 attention does")
    check(bool(torch.isfinite(last).all()), "vision: prefill logits are not finite")
    check(launches["flash_attention"] == cfg.n_layers and designs["flash_attention"] ==
          {"simt": 0, "wgmma": cfg.n_layers},
          f"vision: the prefill launched flash {designs['flash_attention']}, not "
          f"{cfg.n_layers} wgmma")
    del plain, jax_route, last
    free_memory(torch)
    serve = phase_serve(torch, cfg, params, seed, kernels, card, tag="[vision] qwen2-vl-72b")
    del params
    free_memory(torch)
    return {"vision_prefill": prefill, "vision_serve": serve}


def phase_encdec_vision(torch, seed: int, kernels: dict, card: str) -> dict:
    """Phase 9, one model at a time: whisper-tiny in bf16 and its fp32
    exact check, qwen2-vl-72b's vision prefill and serving, and its fp32
    exact check under pool pressure (``phase_exact``)."""
    res = {"whisper": phase_whisper(torch, seed, kernels, card),
           "whisper_exact_launches": phase_whisper_exact(torch, seed, kernels)}
    res.update(phase_vision(torch, seed, kernels, card))
    res["vision_exact_launches"] = phase_exact(torch, seed, kernels, "qwen2-vl-72b")
    res["launches"] = {"whisper-tiny": res["whisper"]["launches"],
                       "whisper-tiny exact fp32": res["whisper_exact_launches"],
                       "qwen2-vl-72b vision prefill": res["vision_prefill"]["launches"],
                       "qwen2-vl-72b serve": res["vision_serve"]["launches"],
                       "qwen2-vl-72b exact fp32": res["vision_exact_launches"]}
    return res


# ---------------------------------------------------------------------------
# phase 6: prefill at full width and depth
# ---------------------------------------------------------------------------

class PrefillProbe:
    """Stands in for ``transformer.prefill`` while the engine runs.

    The first call holds each flash launch to the plain version on the same
    inputs, counts the launches of each flash design, and keeps its
    last-position logits; every call's time (to a synchronize) is kept. The
    forward pass of a profiled row is marked ``prefill.forward``."""

    def __init__(self, torch, prefill):
        self.torch, self.prefill, self.ms, self.first = torch, prefill, [], None
        self.mark = False

    def __call__(self, *args, **kw):
        torch = self.torch
        from torch.profiler import record_function
        from repro_torch.kernels import flash_attention as flash_mod
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.first is not None:
            with record_function("prefill.forward") if self.mark else contextlib.nullcontext():
                out = self.prefill(*args, **kw)
                torch.cuda.synchronize()
        else:
            calls = []
            designs = dict(flash_mod.flash_attention.launches_by_design)
            with checked_flash(torch, calls):
                out = self.prefill(*args, **kw)
            self.first = {"calls": len(calls), "calls_ok": all(ok for _, ok in calls),
                          "call_max_abs_err": max(e for e, _ in calls),
                          "launches_by_design": {
                              d: n - designs[d] for d, n in
                              flash_mod.flash_attention.launches_by_design.items()},
                          "logits": out[0].float().clone()}
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


class RowProbe:
    """Stands in for the engine's ``_prefill_row`` (the forward pass, then
    the page writes of K/V into the pool): times each call to a synchronize,
    and runs call ``profile_at`` under torch.profiler."""

    def __init__(self, torch, row_fn, probe: PrefillProbe, profile_at: int):
        self.torch, self.row_fn, self.probe, self.profile_at = torch, row_fn, probe, profile_at
        self.ms, self.prof = [], None

    def __call__(self, *args, **kw):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if len(self.ms) == self.profile_at:
            self.probe.mark = True
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                self.row_fn(*args, **kw)
                torch.cuda.synchronize()
            self.probe.mark = False
            self.prof = prof
        else:
            self.row_fn(*args, **kw)
            torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)


class StepProbe:
    """Stands in for the engine's decode step while phase 6 runs: times each
    call to a synchronize, with the host time spent inside the paged
    wrapper (its calls timed on the host clock, no synchronize), and runs
    the calls numbered in ``profile_at`` under torch.profiler instead (they
    are not timed), keeping the paged kernel's device time of each. The
    first call holds each paged launch to the plain version on the same
    inputs (``checked_paged``) and is not timed either."""

    def __init__(self, torch, step_fn, profile_at):
        self.torch, self.step_fn, self.profile_at = torch, step_fn, set(profile_at)
        self.ms, self.wrapper_ms, self.paged_ms, self.busy_ms = [], [], [], []
        self.calls, self.first = 0, None

    def _checked(self, args):
        from repro_torch.kernels import ops
        kernel_fn, calls = ops.paged_attention, []
        try:
            ops.paged_attention = checked_paged(self.torch, kernel_fn, calls)
            out = self.step_fn(*args)
        finally:
            ops.paged_attention = kernel_fn
        self.first = checked_summary(calls)
        return out

    def _timed(self, args):
        from repro_torch.kernels import ops
        kernel_fn, spent = ops.paged_attention, []

        def timed_call(*a, **kw):
            t0 = time.perf_counter()
            out = kernel_fn(*a, **kw)
            spent.append(time.perf_counter() - t0)
            return out

        t0 = time.perf_counter()
        try:
            ops.paged_attention = timed_call
            out = self.step_fn(*args)
            self.torch.cuda.synchronize()
        finally:
            ops.paged_attention = kernel_fn
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.wrapper_ms.append(sum(spent) * 1e3)
        return out

    def __call__(self, *args):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        n, self.calls = self.calls, self.calls + 1
        torch.cuda.synchronize()
        if n == 0:
            return self._checked(args)
        if n not in self.profile_at:
            return self._timed(args)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = self.step_fn(*args)
            torch.cuda.synchronize()
        dev = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3
               for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
        self.paged_ms.append(sum(ms for k, ms in dev.items() if "paged_attention" in k))
        self.busy_ms.append(sum(dev.values()))
        return out


def prefill_split(torch, prof) -> dict | None:
    """Device time of a profiled prefill row by kind: kernels that start
    before the end of the ``prefill.forward`` range are the forward pass
    (flash, GEMM, other elementwise work; it ends in a synchronize), those
    after it the page writes. None when the profiler saw no device time."""
    evs = prof.events()
    fwd_end = max((e.time_range.end for e in evs if e.name == "prefill.forward"), default=None)
    split = {"flash": 0.0, "gemm": 0.0, "other_elementwise": 0.0, "page_writes": 0.0}
    launches = dict.fromkeys(split, 0)
    for e in evs:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("prefill"):
            continue
        name = e.name
        key = ("page_writes" if fwd_end is not None and e.time_range.start >= fwd_end else
               "flash" if "flash" in name else
               "gemm" if any(g in name for g in ("gemm", "nvjet", "cutlass", "xmma")) else
               "other_elementwise")
        split[key] += e.time_range.elapsed_us() / 1e3
        launches[key] += 1
    if fwd_end is None or not sum(split.values()):
        return None
    return {"device_ms": split, "launches": launches, "busy_ms": sum(split.values())}


def phase_prefill(torch, cfg, params, seed: int, kernels: dict, card: str) -> dict:
    """Three 4,096-token prompts through the engine at full width and depth.
    The pool (32 sets x 12 pages of 16 tokens, the paper's set size) holds
    one such request at a time, so each waits for the one before to finish.
    The first prefill is checked, the second timed (time to first token),
    the third profiled."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServeEngine

    page, num_sets, set_size = 16, 32, 12
    n_pages = PREFILL_TOKENS // page + 1      # the prompt and the next position
    eng = ServeEngine(cfg, params, max_batch=2, page_size=page, num_sets=num_sets,
                      set_size=set_size, max_pages=n_pages + 7, device="cuda")
    rng = np.random.default_rng(seed + 6)
    prompts = [[int(x) for x in rng.integers(1, cfg.vocab, PREFILL_TOKENS)] for _ in range(3)]
    # the reference: the first prompt's prefill with plain attention
    with torch.no_grad(), plain_flash():
        plain, _ = T.prefill(params, torch.tensor([prompts[0]], device="cuda"), cfg,
                             max_seq=n_pages * page)
    plain = plain.float()
    free_memory(torch)

    probe = PrefillProbe(torch, T.prefill)
    rows = RowProbe(torch, eng._prefill_row, probe, profile_at=2)
    eng._prefill_row = rows
    steps = StepProbe(torch, eng.step_fn, profile_at=(9, 10, 11))   # the second request's
    eng.step_fn = steps
    rids = [eng.submit(p, max_new=PREFILL_NEW) for p in prompts]
    zero_launches(kernels)
    t0 = time.perf_counter()
    try:
        T.prefill = probe
        eng.run(max_steps=300)
    finally:
        T.prefill = probe.prefill
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(kernels)
    designs = read_designs(kernels)
    eng.close()
    first = probe.first
    got = first["logits"]
    rel_l2 = ((got - plain).norm() / plain.norm()).item()
    done = sum(eng.result(r).state == "done" for r in rids)
    check(len(probe.ms) == 3 and len(rows.ms) == 3, f"prefill: {len(probe.ms)} prefills, not 3")
    ttft = probe.ms[1]
    split = prefill_split(torch, rows.prof)
    res = {"requests": len(rids), "done": done, "prompt_tokens": PREFILL_TOKENS,
           "prefill_ms": probe.ms, "prefill_row_ms": rows.ms, "ttft_ms": ttft, "seconds": dt,
           "launches": launches, "launches_by_design": designs,
           "first_prefill": {k: v for k, v in first.items() if k != "logits"},
           "logits_rel_l2": rel_l2, "logits_max_abs_err": (got - plain).abs().max().item(),
           "argmax_equal": bool(got.argmax() == plain.argmax()), "stats": eng.stats(),
           "profile": split, "decode_steps": steps.calls, "first_decode_step": steps.first,
           "decode_step_median_ms": statistics.median(steps.ms),
           "decode_step_ms": steps.ms,
           "decode_paged_wrapper_host_ms_per_step": statistics.median(steps.wrapper_ms),
           "decode_paged_device_ms_per_step": (statistics.mean(steps.paged_ms)
                                               if any(steps.paged_ms) else None),
           "decode_device_busy_ms_per_step": (statistics.mean(steps.busy_ms)
                                              if any(steps.busy_ms) else None)}
    paged_dev = res["decode_paged_device_ms_per_step"]
    print(f"[prefill] first decode step over 4,097 keys: {steps.first['calls']} paged launches "
          f"vs plain version on the same inputs max_abs_err {steps.first['call_max_abs_err']:.3e} "
          f"(tol {BF16_TOL:g}), rel L2 {steps.first['call_max_rel_l2']:.2e} (tol "
          f"{PAGED_REL_L2_BF16:g}) {'ok' if steps.first['calls_ok'] else 'FAIL'}", flush=True)
    print(f"[prefill] decode steps over 4,097-4,104-key contexts (1 active row of 2): "
          f"{steps.calls} steps, median {res['decode_step_median_ms']:.2f} ms over the "
          f"{len(steps.ms)} timed (before the profiled ones "
          f"{statistics.median(steps.ms[:min(steps.profile_at) - 1]):.2f} ms, after "
          f"{statistics.median(steps.ms[min(steps.profile_at) - 1:]):.2f} ms), of which inside the "
          f"paged wrapper (host clock) {res['decode_paged_wrapper_host_ms_per_step']:.2f} ms; "
          f"{len(steps.paged_ms)} steps under torch.profiler: paged "
          f"kernel device time per step "
          f"{'%.4f ms' % paged_dev if paged_dev else 'not measured'} (36 layers), device busy "
          f"{'%.2f ms' % res['decode_device_busy_ms_per_step'] if paged_dev else 'not measured'}"
          f" on {card}", flush=True)
    print(f"[prefill] first prefill: {first['calls']} flash launches {first['launches_by_design']} "
          f"vs plain version on the same inputs max_abs_err {first['call_max_abs_err']:.3e} (tol "
          f"{BF16_TOL:g}) {'ok' if first['calls_ok'] else 'FAIL'}; last-position logits with the "
          f"kernel vs a plain-attention prefill: relative L2 {rel_l2:.3e} (tol {BF16_TOL:g}), "
          f"max_abs_err {res['logits_max_abs_err']:.3e}, argmax equal {res['argmax_equal']}",
          flush=True)
    print(f"[prefill] qwen3-8b bf16, {len(rids)} requests x {PREFILL_TOKENS}-token prompts, "
          f"{PREFILL_NEW} new tokens, page {page}, {num_sets} x {set_size} sets: {done}/"
          f"{len(rids)} done in {dt:.2f} s; prefill (time to first token once admitted) "
          f"{ttft:.1f} ms (first, with the checks: {probe.ms[0]:.1f} ms; third, profiled: "
          f"{probe.ms[2]:.1f} ms); prefill + page writes {rows.ms[1]:.1f} ms; launches "
          f"{launches} {designs}; stats {eng.stats()} on {card}", flush=True)
    if split is None:
        print("[profile] the profiler recorded no device time for the prefill: its split is "
              "not measured", flush=True)
    else:
        dev = split["device_ms"]
        fwd = dev["flash"] + dev["gemm"] + dev["other_elementwise"]
        res["busy_share_forward"] = fwd / ttft
        res["busy_share_page_writes"] = dev["page_writes"] / max(rows.ms[1] - ttft, 1e-9)
        print(f"[profile] third prefill (profiled), device time: flash {dev['flash']:.2f} ms, "
              f"GEMM {dev['gemm']:.2f} ms, other elementwise {dev['other_elementwise']:.2f} ms, "
              f"page writes {dev['page_writes']:.2f} ms ({split['launches']} launches); "
              f"forward busy {fwd:.2f} ms = {100 * res['busy_share_forward']:.1f} % of the "
              f"unprofiled time to first token {ttft:.1f} ms; page writes busy "
              f"{100 * res['busy_share_page_writes']:.1f} % of their unprofiled "
              f"{rows.ms[1] - ttft:.1f} ms on {card}", flush=True)
    check(first["calls_ok"] and first["calls"] == cfg.n_layers,
          "prefill: a flash launch of the first prefill differs from the plain version")
    check(first["launches_by_design"] == {"simt": 0, "wgmma": cfg.n_layers},
          f"prefill: the first prefill's flash launches were {first['launches_by_design']}, "
          f"not {cfg.n_layers} wgmma")
    check(rel_l2 <= BF16_TOL, "prefill: logits with the kernel differ from plain attention's")
    check(done == len(rids) and all(len(eng.result(r).out) == PREFILL_NEW for r in rids),
          f"prefill: only {done}/{len(rids)} requests finished")
    check(launches["flash_attention"] == cfg.n_layers * len(rids),
          f"prefill: {launches['flash_attention']} flash launches for {len(rids)} prefills")
    check(designs["flash_attention"]["wgmma"] == cfg.n_layers * len(rids),
          f"prefill: flash launches by design {designs['flash_attention']}")
    check(launches["paged_attention"] == cfg.n_layers * steps.calls,
          f"prefill: {launches['paged_attention']} paged launches for {steps.calls} decode steps")
    check(len(steps.paged_ms) == 3, f"prefill: {len(steps.paged_ms)} decode steps profiled, not 3")
    check(steps.first["calls_ok"] and steps.first["calls"] == cfg.n_layers,
          "prefill: a paged launch of the first decode step over 4,097 keys differs from the "
          "plain version")
    check(launches["paged_combine"] == launches["paged_attention"],
          "prefill: the decode steps over 4,097+ keys did not all merge splits")
    del eng, probe, rows, steps, plain
    free_memory(torch)
    return res


def decode_probe(torch, seed: int, card: str) -> dict:
    """``--decode-probe SRC``: the paged kernel of the port package under
    SRC (this checkout's, or an earlier commit's unpacked beside it), so two
    designs can be compared in one run on one card. The wrapper's host time
    per call at the serve and decode-4k shapes, then phase 6's decode over
    4,097+-key contexts with 16 new tokens per request: each paged launch of
    the first step held to the plain version, the median step, the host time
    inside the wrapper per step, and the paged kernel's device time per step
    (torch.profiler, 3 steps)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.serving import ServeEngine

    rng = np.random.default_rng(seed + 7)
    host_us = {}
    for name in ("serve", "decode-4k"):
        maxp, pool, lengths, _ = PAGED_TIMED[name]
        q, kp, vp, table, lens = timed_paged_inputs(torch, rng, maxp, pool, lengths, 1)
        host_us[name] = wrapper_host_us(
            torch, lambda: ops.paged_attention(q, kp[0], vp[0], table, lens))
        del q, kp, vp
    free_memory(torch)
    cfg, params = load_model(torch, "qwen3-8b", seed)
    page = 16
    eng = ServeEngine(cfg, params, max_batch=2, page_size=page, num_sets=32, set_size=12,
                      max_pages=PREFILL_TOKENS // page + 8, device="cuda")
    steps = StepProbe(torch, eng.step_fn, profile_at=(9, 10, 11))
    eng.step_fn = steps
    rids = [eng.submit([int(x) for x in rng.integers(1, cfg.vocab, PREFILL_TOKENS)], max_new=16)
            for _ in range(3)]
    eng.run(max_steps=300)
    torch.cuda.synchronize()
    eng.close()
    res = {"paged_module": paged_mod.__file__, "card": card,
           "done": sum(eng.result(r).state == "done" for r in rids),
           "wrapper_host_us_per_call": host_us, "first_decode_step": steps.first,
           "decode_steps": steps.calls, "decode_step_median_ms": statistics.median(steps.ms),
           "decode_paged_wrapper_host_ms_per_step": statistics.median(steps.wrapper_ms),
           "decode_paged_device_ms_per_step": statistics.mean(steps.paged_ms),
           "decode_device_busy_ms_per_step": statistics.mean(steps.busy_ms),
           "decode_step_ms": steps.ms}
    check(res["done"] == len(rids), f"decode probe: only {res['done']} requests finished")
    check(steps.first["calls_ok"], "decode probe: a paged launch differs from the plain version")
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
    before = read_designs(kernels)["flush_scores"]
    t0 = time.perf_counter()
    got = sa_cache.select_flush_candidates(card_state, 6, 2)   # paper: trigger 6, 1-2 per visit
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(kernels)
    designs = read_designs(kernels)["flush_scores"]
    select_designs = {d: designs[d] - before[d] for d in designs}
    want = sa_cache.select_flush_candidates(cpu, 6, 2)
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    print(f"[sa-cache] quickstart twin on the card ok; select_flush_candidates at {ns} sets x "
          f"{ss} (trigger 6, 2 per set): {int(want[0].sum())} sets to flush, card "
          f"{'==' if same else '!='} CPU, {card_ms:.2f} ms on the host clock, flush launches "
          f"by design {select_designs}; launches {launches} {designs} on {card}", flush=True)
    check(same, "sa-cache: select_flush_candidates on the card differs from the CPU's")
    check(launches["flush_scores"] > 0, "sa-cache: the flush_scores kernel was not launched")
    check(select_designs == {"slot": 0, "set": 1},
          f"sa-cache: select_flush_candidates launched {select_designs}, not one set kernel")
    return {"launches": launches, "launches_by_design": designs, "equal": same,
            "select_ms": card_ms}


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

TRAIN_EXACT = ("tinyllama-1.1b", "olmoe-1b-7b", "mamba2-780m", "whisper-tiny")
TRAIN_EXACT_SHAPE = (4, 512, 2)           # batch, seq, microbatches of the route checks
TRAIN_FULL_SHAPE = (8, 2048, 2)           # tinyllama's pretraining length, 2 microbatches
TRAIN_STEPS, TRAIN_CKPT_STEP, TRAIN_PROFILED = 20, 9, 2
TRAIN_TOLS = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2e-2)}   # loss rel, grad rel L2
TRAIN_RESUME_TOL = 1e-3     # resumed losses: cuBLAS and the embedding's atomics reorder sums
TRAIN_ATTN_SHAPE = (4, 2048, 32, 4, 64)   # one microbatch's attention call: B, S, H, KV, hd
QWEN3_ATTN_SHAPE = (1, 4096, 32, 8, 128)  # qwen3-8b's training attention call: B, S, H, KV, hd
TRAIN_ATTN_GRAD_TOL = 1e-2   # relative L2 of dq, dk, dv in bf16 (tests/test_torch_cuda.py)
TRAIN_DOTS_TOL = 1e-5        # remat="dots" gradients against remat=True's, relative L2, fp32
TRAIN_DOTS_STEPS = 3         # full-size steps timed under remat="dots" (the first one warms)


def train_config(arch: str, dtype: str):
    """The route checks' configuration: the published width with the depth
    cut to 2 layers (whisper-tiny at its full size), in ``dtype``."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    layers = cfg.n_layers if cfg.encoder_layers else 2
    return dataclasses.replace(cfg, n_layers=layers, dtype=dtype)


def train_batch(cfg, seed: int, batch: int, seq: int, step: int) -> dict:
    """Step ``step`` of ``SyntheticLM(seed)`` on the card, with ``launch.train``'s
    stub inputs for whisper and qwen2-vl."""
    from repro_torch.data import SyntheticLM, to_device
    from repro_torch.launch.train import modality_stubs

    raw = SyntheticLM(cfg.vocab, seq, batch, seed=seed).batch(step)
    return to_device(modality_stubs(raw, cfg, batch, seq, seed, step), "cuda")


def flash_per_microbatch(cfg) -> int:
    """Flash launches of one microbatch under remat: every attention call of
    a decoder block forward and again in its recompute (self- and, for
    whisper, cross-attention), and whisper's encoder layers once (its
    encoder is not rematerialised, as in JAX)."""
    per_block = attn_layers(cfg) * (2 if cfg.encoder_layers else 1)
    return cfg.encoder_layers + 2 * per_block


def backward_per_microbatch(cfg) -> int:
    """Backward kernel launches of one microbatch: one for each attention
    call of the forward (the recompute adds none)."""
    return cfg.encoder_layers + attn_layers(cfg) * (2 if cfg.encoder_layers else 1)


@contextlib.contextmanager
def plain_backward_on_card(calls: list):
    """Appends to ``calls`` the shape of q at each call of the plain
    ``ref.flash_attention_bwd`` on a CUDA tensor while it is active: on the
    training path the backward is the kernel, so none may come."""
    from repro_torch.kernels import ref

    plain = ref.flash_attention_bwd

    def counted(q, *args, **kw):
        if q.is_cuda:
            calls.append(tuple(q.shape))
        return plain(q, *args, **kw)

    ref.flash_attention_bwd = counted
    try:
        yield
    finally:
        ref.flash_attention_bwd = plain


def train_route(torch, cfg, params, batch: dict, kernels: dict, plain: bool) -> dict:
    """The train step's gradient and metrics (``make_grad_fn``, which
    ``make_train_step`` runs before AdamW; remat, the microbatches of
    ``TRAIN_EXACT_SHAPE``), with the flash kernels (forward and backward) or
    (``plain``) the plain version forward under autograd, launches counted."""
    from repro_torch.launch.steps import make_grad_fn

    grad_fn = make_grad_fn(cfg, remat=True, microbatches=TRAIN_EXACT_SHAPE[2])
    with plain_flash() if plain else contextlib.nullcontext():
        zero_launches(kernels)
        grads, metrics = grad_fn(params, batch)
        torch.cuda.synchronize()
        launches, designs = read_launches(kernels), read_designs(kernels)
    return {"ce": float(metrics["ce"]), "grads": grads, "launches": launches,
            "designs": designs["flash_attention"], "bwd_designs": designs["flash_attention_bwd"]}


def train_exact(torch, arch: str, dtype: str, seed: int, kernels: dict) -> dict:
    """The kernel route's train step against the plain route's on the same
    weights and batch: the losses within ``TRAIN_TOLS``' relative bound,
    every gradient leaf within its relative L2 bound and nonzero through the
    kernel route, the flash launches ``flash_per_microbatch`` x microbatches,
    each of the design ``dtype`` takes (fp32: simt, bf16 at hd 64: wgmma)."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten_with_paths

    cfg = train_config(arch, dtype)
    b, s, mb = TRAIN_EXACT_SHAPE
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    batch = train_batch(cfg, seed, b, s, 0)
    kern = train_route(torch, cfg, params, batch, kernels, plain=False)
    plain = train_route(torch, cfg, params, batch, kernels, plain=True)
    loss_tol, grad_tol = TRAIN_TOLS[dtype]
    rel = {key: rel_l2(g, w) for (key, g), w in
           zip(flatten_with_paths(kern["grads"]).items(), flatten_with_paths(plain["grads"]).values())}
    zero = [key for key, g in flatten_with_paths(kern["grads"]).items() if not bool(g.abs().max() > 0)]
    finite = all(bool(torch.isfinite(g).all()) for g in flatten_with_paths(kern["grads"]).values())
    loss_rel = abs(kern["ce"] - plain["ce"]) / abs(plain["ce"])
    want = flash_per_microbatch(cfg) * mb
    want_bwd = backward_per_microbatch(cfg) * mb
    design = "simt" if dtype == "float32" else "wgmma"
    worst = max(rel, key=rel.get)
    res = {"arch": arch, "dtype": dtype, "layers": cfg.n_layers, "batch": b, "seq": s,
           "microbatches": mb, "ce_kernel": kern["ce"], "ce_plain": plain["ce"],
           "loss_rel": loss_rel, "grad_leaves": len(rel), "max_grad_rel_l2": rel[worst],
           "worst_leaf": worst, "zero_grad_leaves": zero, "flash_launches":
           kern["launches"]["flash_attention"], "flash_expected": want,
           "designs": kern["designs"], "plain_route_flash_launches":
           plain["launches"]["flash_attention"],
           "backward_launches": kern["launches"]["flash_attention_bwd"],
           "backward_expected": want_bwd, "backward_designs": kern["bwd_designs"],
           "plain_route_backward_launches": plain["launches"]["flash_attention_bwd"]}
    print(f"[train] {arch} {dtype} d_model {cfg.d_model}, {cfg.n_layers} layers, batch {b} x "
          f"{s}, {mb} microbatches, remat: ce kernel route {kern['ce']:.6f} vs plain "
          f"{plain['ce']:.6f} (rel {loss_rel:.2e}, tol {loss_tol:g}); {len(rel)} gradient "
          f"leaves, max rel L2 {rel[worst]:.2e} ({worst}; tol {grad_tol:g}), zero leaves "
          f"{zero}; flash launches {res['flash_launches']} (expected {want}) {kern['designs']}, "
          f"backward launches {res['backward_launches']} (expected {want_bwd}) "
          f"{kern['bwd_designs']}, plain route {res['plain_route_flash_launches']} and "
          f"{res['plain_route_backward_launches']}", flush=True)
    check(loss_rel <= loss_tol, f"train {arch} {dtype}: loss differs from the plain route's")
    check(rel[worst] <= grad_tol, f"train {arch} {dtype}: gradient leaf {worst} differs "
          f"from the plain route's by {rel[worst]:.2e} relative L2")
    check(not zero and finite, f"train {arch} {dtype}: leaves with a zero or non-finite "
          f"gradient through the kernel route: {zero}")
    check(res["flash_launches"] == want and kern["designs"][design] == want,
          f"train {arch} {dtype}: {kern['designs']} flash launches, expected {want} {design}")
    check(res["backward_launches"] == want_bwd and kern["bwd_designs"][design] == want_bwd,
          f"train {arch} {dtype}: {kern['bwd_designs']} backward launches, expected {want_bwd} "
          f"{design}")
    check(res["plain_route_flash_launches"] == res["plain_route_backward_launches"] == 0,
          f"train {arch}: the plain route launched a flash kernel")
    del params, batch, kern, plain
    free_memory(torch)
    return res


def train_dots(torch, seed: int, kernels: dict) -> dict:
    """``remat="dots"`` (JAX's ``dots_saveable`` as a selective checkpoint)
    against ``remat=True`` on tinyllama-1.1b at 2 layers of its published
    width, fp32, through the kernel: one step's gradient (``make_grad_fn``,
    ``TRAIN_EXACT_SHAPE``), every leaf within ``TRAIN_DOTS_TOL`` relative
    L2, and the flash launches: the forward alone under ``"dots"`` (its
    saved output is not recomputed), forward and recompute under ``True``."""
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten_with_paths

    cfg = train_config("tinyllama-1.1b", "float32")
    b, s, mb = TRAIN_EXACT_SHAPE
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    batch = train_batch(cfg, seed, b, s, 0)
    out = {}
    for remat in (True, "dots"):
        zero_launches(kernels)
        grads, metrics = make_grad_fn(cfg, remat=remat, microbatches=mb)(params, batch)
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        out[remat] = (flatten_with_paths(grads), float(metrics["ce"]),
                      launches["flash_attention"], launches["flash_attention_bwd"])
    (full, ce_full, n_full, b_full), (dots, ce_dots, n_dots, b_dots) = out[True], out["dots"]
    rel = {k: rel_l2(dots[k], full[k]) for k in full}
    worst = max(rel, key=rel.get)
    want = (attn_layers(cfg) * mb, flash_per_microbatch(cfg) * mb)
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": b, "seq": s, "microbatches": mb,
           "ce_dots": ce_dots, "ce_remat": ce_full, "max_grad_rel_l2": rel[worst],
           "worst_leaf": worst, "flash_launches": {"dots": n_dots, "remat": n_full},
           "flash_expected": {"dots": want[0], "remat": want[1]},
           "backward_launches": {"dots": b_dots, "remat": b_full}, "backward_expected": want[0]}
    print(f"[train] remat='dots' vs remat=True, {cfg.name} fp32 {cfg.n_layers} layers, batch "
          f"{b} x {s}, {mb} microbatches: ce {ce_dots:.6f} vs {ce_full:.6f}; {len(rel)} leaves, "
          f"max rel L2 {rel[worst]:.2e} ({worst}; tol {TRAIN_DOTS_TOL:g}); flash launches "
          f"{n_dots} under 'dots' (expected {want[0]}: no recompute), {n_full} under True "
          f"(expected {want[1]}); backward launches {b_dots} and {b_full} (expected {want[0]})",
          flush=True)
    check(rel[worst] <= TRAIN_DOTS_TOL, f"train: remat='dots' gradient leaf {worst} differs "
          f"from remat=True's by {rel[worst]:.2e} relative L2")
    check((n_dots, n_full) == want, f"train: flash launches {n_dots} / {n_full} under 'dots' / "
          f"True, expected {want}")
    check(b_dots == b_full == want[0], f"train: backward launches {b_dots} / {b_full} under "
          f"'dots' / True, expected {want[0]}")
    del params, batch, out, full, dots
    free_memory(torch)
    return res


def dots_steps(torch, cfg, params, opt, data, first: int, kernels: dict) -> dict:
    """``TRAIN_DOTS_STEPS`` steps of the full-size train step under
    ``remat="dots"`` on ``data``'s batches from ``first``, continuing
    ``params`` and ``opt``: their ms (the median of those after the first),
    the peak memory and the flash launches (the forward only: its saved
    output is not recomputed)."""
    from repro_torch.data import to_device
    from repro_torch.launch.steps import make_train_step

    b, s, mb = TRAIN_FULL_SHAPE
    step_fn = make_train_step(cfg, remat="dots", microbatches=mb, total_steps=TRAIN_STEPS)
    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    ms, losses = [], []
    for i in range(first, first + TRAIN_DOTS_STEPS):
        batch = to_device(data.batch(i), "cuda")
        t0 = time.perf_counter()
        params, opt, met = step_fn(params, opt, batch)
        losses.append(float(met["ce"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_launches(kernels)
    launches, backward = counts["flash_attention"], counts["flash_attention_bwd"]
    want = cfg.n_layers * mb * TRAIN_DOTS_STEPS
    res = {"step_ms": ms, "median_step_ms": statistics.median(ms[1:]), "losses": losses,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "flash_launches": launches,
           "flash_expected": want, "backward_launches": backward}
    check(all(np.isfinite(losses)), "train: a loss under remat='dots' is not finite")
    check(launches == backward == want, f"train: {launches} flash and {backward} backward "
          f"launches in {TRAIN_DOTS_STEPS} steps under remat='dots', expected {want} each")
    return res


def train_profile(torch, run, steps: int) -> dict:
    """Device ms per step under torch.profiler, split into the flash
    kernel's forward launches, the attention backward (the range
    ``flash_attention_backward``), the optimizer (``adamw_update``), the
    GEMMs outside those two ranges, and the rest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    ranges = {"flash_attention_backward": [0.0, 0.0], "adamw_update": [0.0, 0.0]}
    # device kernels by name; the ranges also show up as device-side annotations
    by_name = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3 / steps
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges}
    is_gemm = lambda name: any(s in name for s in ("gemm", "nvjet", "cutlass", "xmma"))
    for ev in prof.events():
        tag, up = None, ev
        while up is not None and tag is None:
            tag = up.name if up.name in ranges else None
            up = up.cpu_parent
        for k in ev.kernels if tag else ():
            ranges[tag][0] += k.duration / 1e3 / steps
            ranges[tag][1] += k.duration / 1e3 / steps if is_gemm(k.name) else 0.0
    total = sum(by_name.values())
    split = {"flash_forward": sum(ms for n, ms in by_name.items() if "flash" in n),
             "attention_backward": ranges["flash_attention_backward"][0],
             "optimizer": ranges["adamw_update"][0],
             "gemm": sum(ms for n, ms in by_name.items() if is_gemm(n))
             - ranges["flash_attention_backward"][1] - ranges["adamw_update"][1]}
    split["other"] = total - sum(split.values())
    return {"device_ms_per_step": total, "split_ms_per_step": split,
            "top": sorted(((ms, n[:90]) for n, ms in by_name.items()), reverse=True)[:10],
            "kernels_ms_per_step": by_name}


def train_full(torch, seed: int, kernels: dict, card: str) -> dict:
    """tinyllama-1.1b at its published size, bf16 with an f32 master copy:
    ``TRAIN_STEPS`` steps of ``make_train_step`` (remat, 2 microbatches) on
    ``SyntheticLM(seed)`` through the ``Prefetcher``, a checkpoint saved at
    ``TRAIN_CKPT_STEP`` and at the end; the end's restored into freshly drawn
    weights equals the trained state bitwise; steps after ``TRAIN_CKPT_STEP``
    rerun from its restore give the same losses (``TRAIN_RESUME_TOL``), the
    last ``TRAIN_PROFILED`` under torch.profiler; then ``dots_steps``. The
    final save goes through ``ServingTraceRecorder.attach_ckpt``: its trace
    (one write row a chunk) is left in ``ckpt_trace`` for phase 13."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import Prefetcher, SyntheticLM, to_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.serving.trace_shim import ServingTraceRecorder
    from repro_torch.tree import flatten_with_paths, leaves

    cfg = get_config("tinyllama-1.1b")
    b, s, mb = TRAIN_FULL_SHAPE
    gen = torch.Generator(device="cuda")
    params = T.init_params(cfg, gen.manual_seed(seed), "cuda")
    opt = adamw_init(params)
    n_params = sum(p.numel() for p in leaves(params))
    # the model-FLOP count's N: an untied input embedding is a gather, no matmul
    n_matmul = n_params - (0 if cfg.tie_embeddings else params["embed"].numel())
    state_bytes = sum(t.numel() * t.element_size() for t in leaves((params, opt)))
    state_gb = state_bytes / 1e9
    step_fn = make_train_step(cfg, remat=True, microbatches=mb, total_steps=TRAIN_STEPS)
    data = SyntheticLM(cfg.vocab, s, b, seed=seed)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = CheckpointManager(ckpt_dir)
    it = Prefetcher(({"step": i, **data.batch(i)} for i in range(TRAIN_STEPS)), depth=4)
    losses, norms, ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    save = {}
    try:
        for raw in it:
            i = raw.pop("step")
            batch = to_device(raw, "cuda")
            t0 = time.perf_counter()
            params, opt, met = step_fn(params, opt, batch)
            losses.append(float(met["ce"]))
            norms.append(float(met["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == TRAIN_CKPT_STEP:
                t0 = time.perf_counter()
                ckpt.save_async(i, (params, opt))
                save["save_ms"] = (time.perf_counter() - t0) * 1e3
                save["bytes"] = state_bytes
    finally:
        it.close()
    launches = read_launches(kernels)
    designs = read_designs(kernels)["flash_attention"]
    bwd_designs = read_designs(kernels)["flash_attention_bwd"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    committed = ckpt.wait_for_commit(TRAIN_CKPT_STEP, 600)
    save["wait_commit_ms"] = (time.perf_counter() - t0) * 1e3
    # the final save is recorded: its writes are pumped on this thread by drain
    rec = ServingTraceRecorder(ckpt.n_targets).attach_ckpt(ckpt)
    t0 = time.perf_counter()
    ckpt.save_async(TRAIN_STEPS - 1, (params, opt))
    save["final_save_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    drained = ckpt.drain(900)
    save["drain_ms"] = (time.perf_counter() - t0) * 1e3
    save["bytes_written"] = ckpt.stats["bytes"]
    ckpt_trace = {"trace": rec.to_array(), "chunks": len(flatten_with_paths((params, opt))),
                  "n_targets": ckpt.n_targets, "save_ms": save["final_save_ms"],
                  "write_ms": save["drain_ms"], "bytes": state_bytes}
    check(committed and drained and ckpt.latest_step() == TRAIN_STEPS - 1,
          f"train: the checkpoints did not commit ({ckpt.stats})")
    ckpt.close()
    ckpt = CheckpointManager(ckpt_dir)    # reopened, as a resumed job opens it

    free_memory(torch)
    fresh = T.init_params(cfg, gen.manual_seed(seed + 1), "cuda")
    like = (fresh, adamw_init(fresh))
    t0 = time.perf_counter()
    _, restored = ckpt.restore(like)
    torch.cuda.synchronize()
    save["restore_ms"] = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(x, y) and x.dtype == y.dtype
               for x, y in zip(leaves(restored), leaves((params, opt))))
    del restored, params, opt
    free_memory(torch)
    _, (params, opt) = ckpt.restore(like, step=TRAIN_CKPT_STEP)
    del like, fresh
    free_memory(torch)
    rerun = {}

    def resume_step():
        i = TRAIN_CKPT_STEP + 1 + len(rerun)
        nonlocal params, opt
        params, opt, met = step_fn(params, opt, to_device(data.batch(i), "cuda"))
        rerun[i] = float(met["ce"])

    for _ in range(TRAIN_STEPS - TRAIN_CKPT_STEP - 1 - TRAIN_PROFILED):
        resume_step()
    prof = train_profile(torch, resume_step, TRAIN_PROFILED)
    ckpt.close()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    dots = dots_steps(torch, cfg, params, opt, data, TRAIN_STEPS, kernels)
    del params, opt
    free_memory(torch)

    median = statistics.median(ms[1:])
    tokens = b * s
    attn_flops = 6 * cfg.n_layers * cfg.n_heads * cfg.head_dim * s * tokens
    model_flops = 6 * n_matmul * tokens + attn_flops
    resume_rel = max(abs(rerun[i] - losses[i]) / abs(losses[i]) for i in rerun)
    busy = prof["device_ms_per_step"]
    res = {"arch": cfg.name, "params": n_params, "matmul_params": n_matmul, "state_gb": state_gb, "batch": b, "seq": s,
           "microbatches": mb, "steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
           "step_ms": ms, "median_step_ms": median, "tokens_per_s": tokens / median * 1e3,
           "model_flops_per_step": model_flops, "attention_flops_per_step": attn_flops,
           "mfu": model_flops / (median / 1e3) / BF16_PEAK_FLOPS, "peak_gb": peak_gb,
           "launches": launches, "designs": designs, "backward_designs": bwd_designs,
           "checkpoint": save,
           "restore_bitwise": same, "resumed_losses": rerun, "resume_max_rel": resume_rel,
           "profile": prof, "busy_share": busy / median if busy else None, "dots": dots,
           "ckpt_trace": ckpt_trace, "card": card}
    print(f"[train] {cfg.name} full size, bf16 weights + f32 master: {n_params / 1e9:.3f}B "
          f"params, {state_gb:.2f} GB of weights and optimizer state; batch {b} x {s}, "
          f"{mb} microbatches, remat, {TRAIN_STEPS} steps: ce {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, grad norms {min(norms):.3f}-{max(norms):.3f}", flush=True)
    print(f"[train] median step {median:.1f} ms (steps 1-{TRAIN_STEPS - 1}; step 0 "
          f"{ms[0]:.1f}), {res['tokens_per_s']:,.0f} tokens/s, model FLOP share "
          f"{100 * res['mfu']:.2f} % of {BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s (6 N tokens + "
          f"6 L H hd S tokens of causal attention = {model_flops / 1e12:.1f} TFLOP a step, "
          f"N = {n_matmul:,}, the parameters less the untied input embedding); peak {peak_gb:.1f} GB; flash launches {launches['flash_attention']} "
          f"{designs}, backward launches {launches['flash_attention_bwd']} {bwd_designs} on "
          f"{card}", flush=True)
    split = prof["split_ms_per_step"]
    print(f"[train] torch.profiler over {TRAIN_PROFILED} resumed steps: device busy "
          f"{busy:.1f} ms a step = {100 * (res['busy_share'] or 0):.1f} % of the median step; "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + " ms", flush=True)
    for t, name in prof["top"]:
        print(f"[train]   {t:9.3f} ms/step  {name}")
    print(f"[train] checkpoint: {save['bytes'] / 1e9:.2f} GB a save; step {TRAIN_CKPT_STEP}'s "
          f"save_async {save['save_ms']:.0f} ms on the train thread, its commit awaited "
          f"{save['wait_commit_ms']:.0f} ms after the last step; final save_async "
          f"{save['final_save_ms']:.0f} ms, drain {save['drain_ms']:.0f} ms; restore "
          f"{save['restore_ms']:.0f} ms, bitwise equal to the trained state: {same}; steps "
          f"{TRAIN_CKPT_STEP + 1}-{TRAIN_STEPS - 1} rerun from step {TRAIN_CKPT_STEP}'s "
          f"restore: max rel loss difference {resume_rel:.2e} (tol {TRAIN_RESUME_TOL:g})",
          flush=True)
    print(f"[train] remat='dots' at full size, {TRAIN_DOTS_STEPS} steps after the "
          f"{TRAIN_STEPS}: median step {dots['median_step_ms']:.1f} ms (steps "
          f"{', '.join(f'{x:.1f}' for x in dots['step_ms'])}), peak {dots['peak_gb']:.1f} GB, "
          f"flash launches {dots['flash_launches']} (the forward only), backward "
          f"{dots['backward_launches']}, beside remat=True's "
          f"median {median:.1f} ms and peak {peak_gb:.1f} GB in this run, on {card}", flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)) and all(np.isfinite(list(rerun.values()))),
          "train: a loss or grad norm is not finite")
    check(same, "train: the restored checkpoint differs from the trained state")
    check(resume_rel <= TRAIN_RESUME_TOL, "train: the resumed losses differ")
    want = cfg.n_layers * 2 * mb * TRAIN_STEPS
    check(launches["flash_attention"] == want and designs["wgmma"] == want,
          f"train: {designs} flash launches in {TRAIN_STEPS} steps, expected {want} wgmma")
    want_bwd = cfg.n_layers * mb * TRAIN_STEPS
    check(launches["flash_attention_bwd"] == want_bwd and bwd_designs["wgmma"] == want_bwd,
          f"train: {bwd_designs} backward launches in {TRAIN_STEPS} steps, expected {want_bwd} "
          "wgmma")
    return res


def backward_probe(torch, seed: int, card: str) -> dict:
    """``--backward-probe SRC``: ``time_attention_backward`` with the port
    package under SRC, so two commits' backwards can be compared in one run."""
    from repro_torch.kernels import ops

    return {"ops_module": ops.__file__, "card": card, **time_attention_backward(torch, card)}


def time_attention_backward(torch, card: str) -> dict:
    """``attention_backward_at`` tinyllama's training shape (``TRAIN_ATTN_SHAPE``),
    and under ``"qwen3_8b"`` at qwen3-8b's (``QWEN3_ATTN_SHAPE``)."""
    t = attention_backward_at(torch, card, TRAIN_ATTN_SHAPE)
    t["qwen3_8b"] = attention_backward_at(torch, card, QWEN3_ATTN_SHAPE)
    return t


def attention_backward_at(torch, card: str, shape: tuple) -> dict:
    """One attention call's gradient at ``shape`` (B, S, H, KV, hd; causal,
    bf16): first ``ops.flash_attention``'s output held to the plain
    version's (``FLASH_BF16_TOL``) and its dq, dk, dv to autograd through the
    plain version (``TRAIN_ATTN_GRAD_TOL`` relative L2). Then, timed: the
    backward kernel alone (``flash_attention_backward`` on the forward
    kernel's output and log-sum-exp; device time, CUDA graph replay) and its
    three kernels' device time a launch by torch.profiler (D, dK/dV, dQ), its plain
    version ``ref.flash_attention_bwd``, ``scaled_dot_product_attention``'s
    backward (the library's, a yardstick only) and, as autograd runs them
    (eager, host launches included), the Function's backward and autograd
    through the plain version, so the Function and SDPA are also read on the
    same footing; beside the bound of the function (dq, dk, dv from q, k, v,
    out, do: ``flash_attention_bwd.cost``, the five products of each causal
    pair at the bf16 peak; the bytes are far below it). A package without
    the backward kernel (an earlier commit's, ``--backward-probe``) gets the
    eager times only."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    b, s, h, kv, hd = shape
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(dims, generator=g, device="cuda").to(torch.bfloat16)
                   for dims in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    wants = torch.autograd.grad(want, (q, k, v), do)
    out_err = (out.float() - want.float()).abs().max().item()
    out_ok = bool(torch.allclose(out.float(), want.float(), atol=FLASH_BF16_TOL,
                                 rtol=FLASH_BF16_TOL))
    grad_rel = dict(zip(("dq", "dk", "dv"), (rel_l2(g, w) for g, w in zip(grads, wants))))
    grad_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(grads, wants))
    where = f"(B {b}, S {s}, H {h}, KV {kv}, hd {hd}, causal, bf16)"
    print(f"[train] attention at {where}: ops.flash_attention's output vs the plain version "
          f"max_abs_err {out_err:.3e} (tol {FLASH_BF16_TOL:g}); its gradients vs autograd through "
          f"the plain version, relative L2 "
          + ", ".join(f"{n} {e:.2e}" for n, e in grad_rel.items())
          + f" (tol {TRAIN_ATTN_GRAD_TOL:g}), max_abs_err {grad_err:.3e}", flush=True)
    check(out_ok, f"attention at {shape}: the kernel disagrees with the plain version")
    check(max(grad_rel.values()) <= TRAIN_ATTN_GRAD_TOL, f"attention at {shape}: "
          f"the Function's gradients differ from the plain version's autograd: {grad_rel}")
    del out, want, grads, wants
    free_memory(torch)

    def backward_ms(fwd, iters: int) -> float:
        out = fwd()
        run = lambda _: torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
        return time_ms(torch, run, iters)

    t = {"function_ms": backward_ms(lambda: ops.flash_attention(q, k, v), 5),
         "autograd_plain_ms": backward_ms(lambda: ref.flash_attention_ref(q, k, v), 3),
         "library_ms": backward_ms(lambda: F.scaled_dot_product_attention(
             q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
             enable_gqa=True).transpose(1, 2), 10),
         "library": "scaled_dot_product_attention(is_causal=True, enable_gqa=True) backward"}
    free_memory(torch)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
        t["plain_ms"] = time_ms(torch, lambda _: ref.flash_attention_bwd(q, k, v, out, do), 3)
        if hasattr(torch.ops.repro_torch, "flash_attention_backward"):
            from repro_torch.kernels import flash_attention_bwd as bwd_mod

            ops_ = torch.ops.repro_torch
            out, lse = ops_.flash_attention_lse(q, k, v, True, 0, 0.0, 0)
            call = lambda *_: ops_.flash_attention_backward(q, k, v, out, lse, do, True, 0, 0.0, 0)
            t["ms"] = graph_ms(torch, call, 3, reps=5)
            t["kernel_ms"] = kernel_ms_per_launch(torch, call, ("dot", "dkv", "dq"))
            work = bwd_mod.cost(tuple(q.shape), tuple(k.shape), 2, causal=True)
    if "ms" not in t:          # an earlier package: the bound as it was counted then
        work = {"flops": 5 * 2 * b * h * s * s * hd // 2,
                "bytes": 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd) * 2}
    bound_s = max(work["flops"] / BF16_PEAK_FLOPS, work["bytes"] / hbm_bytes_per_s(card))
    t.update(shape=[b, s, h, kv, hd], out_max_abs_err=out_err, grad_rel_l2=grad_rel,
             grad_max_abs_err=grad_err, flops=work["flops"], bytes=work["bytes"],
             bound_ms=bound_s * 1e3, bound_by="operations"
             if work["flops"] / BF16_PEAK_FLOPS >= work["bytes"] / hbm_bytes_per_s(card)
             else "bytes")
    kernel = (f"the backward kernel {t['ms']:.4f} ms (CUDA graph replay, "
              f"{work['flops'] / t['ms'] / 1e9:.1f} TFLOP/s; by torch.profiler D "
              f"{t['kernel_ms']['dot']:.4f}, dK/dV {t['kernel_ms']['dkv']:.4f}, dQ "
              f"{t['kernel_ms']['dq']:.4f} ms), " if "ms" in t else "")
    print(f"[train] attention backward at {where}: {kernel}the plain version "
          f"(ref.flash_attention_bwd) {t['plain_ms']:.2f} ms, autograd of the plain forward "
          f"{t['autograd_plain_ms']:.2f} ms; bound {t['bound_ms']:.3f} ms by {t['bound_by']} "
          f"({work['flops']:.4e} FLOP at {BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s; {work['bytes']} B)"
          f" on {card}", flush=True)
    print(f"[train] attention backward at {where}, eager under autograd (host launches "
          f"included): ops.flash_attention's {t['function_ms']:.3f} ms, "
          f"scaled_dot_product_attention's {t['library_ms']:.3f} ms", flush=True)
    del q, k, v, do, out
    free_memory(torch)
    return t


def phase_train(torch, seed: int, kernels: dict, card: str) -> dict:
    """Phase 10: the kernel route against the plain route, fp32 for each
    of ``TRAIN_EXACT`` and bf16 for tinyllama, ``remat="dots"`` against
    ``remat=True``, then tinyllama-1.1b trained at full size."""
    plain_bwd = []
    with plain_backward_on_card(plain_bwd):
        exact = {arch: train_exact(torch, arch, "float32", seed, kernels)
                 for arch in TRAIN_EXACT}
        exact["tinyllama-1.1b bf16"] = train_exact(torch, "tinyllama-1.1b", "bfloat16", seed,
                                                   kernels)
        dots = train_dots(torch, seed, kernels)
    backward = time_attention_backward(torch, card)      # times the plain version too
    with plain_backward_on_card(plain_bwd):
        full = train_full(torch, seed, kernels, card)
    print(f"[train] ref.flash_attention_bwd on a CUDA tensor in the route checks, the 'dots' "
          f"check and the full-size run: {len(plain_bwd)} calls", flush=True)
    check(not plain_bwd, f"train: the plain backward ran on the card: {plain_bwd[:4]}")
    launches = {**{f"{k} route check": r["flash_launches"] for k, r in exact.items()},
                "remat dots check": dots["flash_launches"]["dots"],
                "tinyllama-1.1b full": full["launches"]["flash_attention"],
                "tinyllama-1.1b full, remat dots": full["dots"]["flash_launches"]}
    bwd = {**{f"{k} route check": r["backward_launches"] for k, r in exact.items()},
           "remat dots check": dots["backward_launches"]["dots"],
           "tinyllama-1.1b full": full["launches"]["flash_attention_bwd"],
           "tinyllama-1.1b full, remat dots": full["dots"]["backward_launches"]}
    return {"exact": exact, "dots": dots, "attention_backward": backward, "full": full,
            "flash_launches": launches, "backward_launches": bwd,
            "plain_backward_on_card": len(plain_bwd)}


# ---------------------------------------------------------------------------
# phase 11: the mesh path (distribution) at world 1
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 5          # of phase 10's 20, on the same weights and batches
MESH_LOSS_TOL = 1e-5          # relative, against phase 10's unsharded losses
MESH_SERVE = ("olmoe-1b-7b", 4)   # arch and requests of the mesh decode (phase 8's traffic)
MESH_DECODE = ("qwen3-8b", 4, 64, 16)   # dense decode: arch, batch, prompt tokens, new tokens
MESH_SSM = ("mamba2-780m", 4, 512, 3)   # train step (fp32): arch, batch, seq, steps


def start_mesh(torch):
    """An NCCL process group of one over a FileStore under ``build/`` (one
    card: NCCL refuses two ranks on one device), and ``make_host_mesh``'s
    (1, 1) mesh over ``data, model``."""
    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    store = ROOT / "build" / "chip_smoke_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    init_process_group("cuda", init_method=f"file://{store}", rank=0, world_size=1)
    return make_host_mesh("cuda")


def quantize_check(torch, grads, card: str) -> dict:
    """``collectives._quantize`` / ``_dequantize`` on the card over every
    gradient leaf (as ``_ef_leaf`` rows them): the int8 payloads and f32
    scales against the CPU's on the same values, differing elements counted
    (expected 0); then the device ms of one compressed pass (each leaf plus
    its residual, quantized, the new residual written) over all leaves,
    beside its bound by bytes."""
    from repro_torch.distributed.collectives import _dequantize, _quantize
    from repro_torch.distributed.sharding import local_part
    from repro_torch.tree import leaves

    rows = []
    for g in leaves(grads):
        x = local_part(g).float()
        rows.append(x.reshape(-1, x.shape[-1]) if x.dim() > 1 else x.reshape(1, -1))
    q_diff = s_diff = elems = 0
    for flat in rows:
        q, sc = _quantize(flat)
        qc, scc = _quantize(flat.cpu())
        q_diff += int((q.cpu() != qc).sum())
        s_diff += int((sc.cpu() != scc).sum())
        elems += q.numel()
        del q, sc, qc, scc
    res = [torch.zeros_like(f) for f in rows]

    def one_pass(_):
        for flat, r in zip(rows, res):
            x = flat + r
            q, sc = _quantize(x)
            r.copy_(x - _dequantize(q, sc))

    ms = time_ms(torch, one_pass, 3)
    # each leaf and residual read once, payload, scales and residual written once
    nbytes = sum(f.numel() * (4 + 4 + 1 + 4) + f.shape[0] * 4 for f in rows)
    out = {"leaves": len(rows), "elements": elems, "payload_differ": q_diff,
           "scales_differ": s_diff, "pass_ms": ms, "bytes": nbytes,
           "bound_ms": nbytes / hbm_bytes_per_s(card) * 1e3}
    print(f"[mesh] int8 error-feedback quantization over {len(rows)} gradient leaves "
          f"({elems:,} elements): payloads differing from the CPU's {q_diff}, scales {s_diff} "
          f"(expected 0); one compressed pass {ms:.3f} ms, bound {out['bound_ms']:.3f} ms by "
          f"bytes ({nbytes / 1e9:.2f} GB) on {card}", flush=True)
    check(q_diff == 0 and s_diff == 0, "mesh: the card's int8 quantization differs from the CPU's")
    del rows, res
    return out


def mesh_train_steps(torch, cfg, mesh, seed: int):
    """``MESH_TRAIN_STEPS`` steps of ``make_train_step(cfg, mesh)`` (remat,
    ``TRAIN_FULL_SHAPE``'s microbatches) from weights drawn from ``seed``
    on the card, placed by ``param_specs``, on ``SyntheticLM(seed)``'s
    batches: (params, opt, losses, ms of each step)."""
    from repro_torch.data import SyntheticLM, make_global_batch
    from repro_torch.distributed import data_spec, distribute_tree, param_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init

    b, s, mb = TRAIN_FULL_SHAPE
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    params = distribute_tree(params, param_specs(params, mesh), mesh)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, mesh, remat=True, microbatches=mb, total_steps=TRAIN_STEPS)
    data = SyntheticLM(cfg.vocab, s, b, seed=seed)
    dspec = data_spec(mesh, b)
    losses, ms = [], []
    torch.cuda.synchronize()
    for i in range(MESH_TRAIN_STEPS):
        batch = make_global_batch(data.batch(i), mesh, dspec, "cuda")
        t0 = time.perf_counter()
        params, opt, met = step_fn(params, opt, batch)
        losses.append(float(met["ce"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return params, opt, losses, ms


def mesh_probe(torch, seed: int, card: str, kernels: dict) -> dict:
    """``--mesh-probe SRC``: phase 11's timed runs with the port package
    under SRC, at world 1: tinyllama's ``mesh_train_steps`` (median of the
    steps after the first), olmoe-1b-7b's paged decode step with
    ``mesh=`` under ``MESH_SERVE``'s traffic (phase 5's prompts; median of
    the steps after the first, each timed to a synchronize), qwen3-8b's
    dense decode unsharded and through ``mesh=`` (``mesh_decode``), and the calls
    of ``transformer._constrain_batch`` a step makes, with the host µs of
    one on an activation that already has its placements (``constrain_us``)
    before the steps and after them."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import distribute_tree, param_specs
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.paged_model import make_paged_decode_step

    constrain = T._constrain_batch
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return constrain(*a, **kw)

    T._constrain_batch = counted
    mesh = start_mesh(torch)
    try:
        us = {"before": constrain_us(torch, mesh, constrain)}
        _, _, losses, train_ms = mesh_train_steps(torch, get_config("tinyllama-1.1b"), mesh,
                                                  seed)
        train_calls = calls[0] / MESH_TRAIN_STEPS
        free_memory(torch)
        arch, n_req = MESH_SERVE
        cfg, params = load_model(torch, arch, seed, tag="[mesh probe]")
        eng = ServeEngine(cfg, params, max_batch=4, page_size=SERVE_PAGE, num_sets=SERVE_POOL[0],
                          set_size=SERVE_POOL[1], device="cuda")
        dparams = distribute_tree(params, param_specs(params, mesh, fsdp=False), mesh)
        mesh_step = make_paged_decode_step(cfg, page_size=SERVE_PAGE, mesh=mesh)
        decode_ms, decode_calls = [], []

        def timed(_, *a):
            c0, t0 = calls[0], time.perf_counter()
            out = mesh_step(dparams, *a)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            decode_calls.append(calls[0] - c0)
            return out

        eng.step_fn = timed
        rng = np.random.default_rng(seed)
        for _ in range(n_req):
            n = int(rng.integers(4, 48))
            eng.submit([int(x) for x in rng.integers(1, cfg.vocab, n)], max_new=24)
        eng.run(max_steps=5000)
        eng.close()
        us["after"] = constrain_us(torch, mesh, constrain)
        del eng, params, dparams
        free_memory(torch)
        dense = mesh_decode(torch, mesh, seed, kernels, card)
    finally:
        T._constrain_batch = constrain
        dist.destroy_process_group()
    return {"transformer_module": T.__file__, "card": card, "train_losses": losses,
            "train_step_ms": train_ms, "train_median_ms": statistics.median(train_ms[1:]),
            "train_constrain_calls_per_step": train_calls,
            "decode_steps": len(decode_ms), "decode_median_ms": statistics.median(decode_ms[1:]),
            "decode_constrain_calls_per_step": statistics.median(decode_calls),
            "constrain_host_us": us,
            "dense_decode": {k: dense[k] for k in (
                "median_step_ms", "unsharded_median_step_ms", "prefill_ms",
                "unsharded_prefill_ms", "same_tokens")}}


def constrain_us(torch, mesh, constrain) -> dict:
    """``wrapper_host_us`` of ``constrain`` (``_constrain_batch``) on a
    (4, 1, 2048) bf16 DTensor on the card that already has the placements
    it asks for, with and without autograd recording; beside it a plain
    ``torch.add`` of the local tensor, the host's own pace."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import P, dp_axes, placements

    x = torch.randn(4, 1, 2048, device="cuda", dtype=torch.bfloat16)
    x = distribute_tensor(x, mesh, placements(P(dp_axes(mesh), None, None), mesh))
    local = x.to_local()
    us = {"add": wrapper_host_us(torch, lambda: torch.add(local, local))}
    for grad in (False, True):
        y = x.detach().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            us["grad" if grad else "no_grad"] = wrapper_host_us(torch, lambda: constrain(y, mesh))
    return us


def mesh_train(torch, mesh, seed: int, kernels: dict, card: str, unsharded: dict) -> dict:
    """tinyllama-1.1b at its published size through the mesh route: params
    and optimizer state DTensors placed by ``param_specs``, the batch by
    ``make_global_batch`` with ``data_spec``, ``make_train_step(cfg, mesh)``
    with remat and 2 microbatches, ``MESH_TRAIN_STEPS`` steps on phase 10's
    weights and batches; the losses held to phase 10's (``unsharded``),
    the flash launches (through ``local_map``) to the unsharded route's
    count; then one gradient for ``quantize_check``."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, make_global_batch
    from repro_torch.distributed import data_spec
    from repro_torch.launch.steps import make_grad_fn

    cfg = get_config("tinyllama-1.1b")
    b, s, mb = TRAIN_FULL_SHAPE
    zero_launches(kernels)
    params, opt, losses, ms = mesh_train_steps(torch, cfg, mesh, seed)
    launches = read_launches(kernels)
    data, dspec = SyntheticLM(cfg.vocab, s, b, seed=seed), data_spec(mesh, b)
    designs = read_designs(kernels)["flash_attention"]
    grads, _ = make_grad_fn(cfg, mesh, remat=True, microbatches=mb)(
        params, make_global_batch(data.batch(MESH_TRAIN_STEPS), mesh, dspec, "cuda"))
    del params, opt
    free_memory(torch)
    quant = quantize_check(torch, grads, card)
    del grads
    free_memory(torch)

    want = unsharded["losses"][:MESH_TRAIN_STEPS]
    rel = max(abs(a - w) / abs(w) for a, w in zip(losses, want))
    expected = cfg.n_layers * 2 * mb * MESH_TRAIN_STEPS
    expected_bwd = cfg.n_layers * mb * MESH_TRAIN_STEPS
    median = statistics.median(ms[1:])
    res = {"arch": cfg.name, "batch": b, "seq": s, "microbatches": mb, "steps": MESH_TRAIN_STEPS,
           "losses": losses, "unsharded_losses": want, "max_rel": rel, "bitwise": losses == want,
           "step_ms": ms, "median_step_ms": median,
           "unsharded_median_step_ms": unsharded["median_step_ms"],
           "flash_launches": launches["flash_attention"], "flash_expected": expected,
           "designs": designs, "backward_launches": launches["flash_attention_bwd"],
           "backward_expected": expected_bwd, "quantize": quant, "card": card}
    print(f"[mesh] {cfg.name} full size on the (1, 1) mesh, params and optimizer state DTensors "
          f"by param_specs, batch {b} x {s} by make_global_batch, {mb} microbatches, remat: "
          f"losses {', '.join(f'{x:.6f}' for x in losses)} vs phase 10's "
          f"{', '.join(f'{x:.6f}' for x in want)}: max rel {rel:.2e} (tol {MESH_LOSS_TOL:g}), "
          f"bitwise {res['bitwise']}; flash launches through local_map "
          f"{launches['flash_attention']} {designs} (the unsharded route's count {expected}), "
          f"backward {launches['flash_attention_bwd']} (expected {expected_bwd})", flush=True)
    print(f"[mesh] median step {median:.1f} ms (steps 1-{MESH_TRAIN_STEPS - 1}) vs phase 10's "
          f"unsharded {unsharded['median_step_ms']:.1f} ms: the difference is DTensor dispatch "
          f"on the host, on {card}", flush=True)
    check(all(np.isfinite(losses)), "mesh: a loss is not finite")
    check(rel <= MESH_LOSS_TOL, "mesh: the mesh route's losses differ from phase 10's")
    check(launches["flash_attention"] == expected and designs["wgmma"] == expected,
          f"mesh: {designs} flash launches, expected {expected} wgmma")
    check(launches["flash_attention_bwd"] == expected_bwd,
          f"mesh: {launches['flash_attention_bwd']} backward launches, expected {expected_bwd}")
    return res


def greedy_decode(torch, T, params, cfg, prompts, new: int, mesh=None) -> dict:
    """``prefill`` then ``new`` greedy ``decode_step``s (with ``mesh``,
    their mesh routes on the cache ``cache_specs`` places): the tokens, the
    last logits, each decode step's ms (to a synchronize) and the prefill's."""
    from repro_torch.distributed.sharding import local_part
    from repro_torch.tree import flatten_with_paths

    b, s = prompts.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, prompts, cfg, s + new, mesh=mesh)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks, ms = [], []
        for _ in range(new):
            tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            t0 = time.perf_counter()
            logits, cache = T.decode_step(params, tok, cache, cfg, mesh=mesh)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    shards = {k: tuple(local_part(v).shape) for k, v in flatten_with_paths(cache).items()}
    return {"tokens": torch.cat(toks, dim=1).cpu(), "logits": logits.float(), "step_ms": ms,
            "prefill_ms": prefill_ms, "shards": shards}


def mesh_decode(torch, mesh, seed: int, kernels: dict, card: str) -> dict:
    """``MESH_DECODE``'s model at its published size, bf16: a prefill of
    random prompts and greedy ``decode_step``s, unsharded and then through
    ``mesh=`` with the cache placed by ``cache_specs`` (the prefill's
    attention, the flash kernel, under ``local_map``): the same tokens, the
    mesh route's flash launches one per attention layer, both medians."""
    from repro_torch.distributed import distribute_tree, param_specs
    from repro_torch.models import transformer as T

    arch, b, s, new = MESH_DECODE
    cfg, params = load_model(torch, arch, seed, tag="[mesh]")
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab, (b, s)).astype(np.int32)).cuda()
    plain = greedy_decode(torch, T, params, cfg, prompts, new)
    dparams = distribute_tree(params, param_specs(params, mesh, fsdp=False), mesh)
    zero_launches(kernels)
    route = greedy_decode(torch, T, dparams, cfg, prompts, new, mesh=mesh)
    launches = read_launches(kernels)
    same = bool(torch.equal(route["tokens"], plain["tokens"]))
    rel = rel_l2(route["logits"], plain["logits"])
    res = {"arch": arch, "batch": b, "prompt": s, "new": new, "same_tokens": same,
           "last_logits_rel_l2": rel, "median_step_ms": statistics.median(route["step_ms"][1:]),
           "unsharded_median_step_ms": statistics.median(plain["step_ms"][1:]),
           "prefill_ms": route["prefill_ms"], "unsharded_prefill_ms": plain["prefill_ms"],
           "cache_shards": route["shards"], "launches": launches}
    print(f"[mesh] {arch} dense prefill + decode_step through mesh= (cache by cache_specs, "
          f"local shards {dict(list(route['shards'].items())[:3])} ...): batch {b} x {s}, {new} "
          f"greedy tokens equal to the unsharded route's: {same} (last logits rel L2 "
          f"{rel:.2e}); median decode step {res['median_step_ms']:.2f} ms vs unsharded "
          f"{res['unsharded_median_step_ms']:.2f} ms, prefill {route['prefill_ms']:.1f} vs "
          f"{plain['prefill_ms']:.1f} ms; flash launches {launches['flash_attention']} on {card}",
          flush=True)
    check(same, f"mesh: {arch}'s mesh decode emitted other tokens than the unsharded route")
    want = attn_layers(cfg)
    check(launches["flash_attention"] == want, f"mesh: {launches['flash_attention']} flash "
          f"launches in the mesh prefill, expected {want}")
    del params, dparams, plain, route
    free_memory(torch)
    return res


def mesh_ssm_train(torch, mesh, seed: int, card: str) -> dict:
    """``MESH_SSM``'s model at its published size in fp32 (in bf16 two
    updates already move the third loss by some 1e-4 between two orders of
    the same sums): its train step (remat) unsharded and then through
    ``mesh=`` from the same weights and batches, the Mamba2 layer under
    ``local_map`` on a rank's rows and heads: the losses within
    ``MESH_LOSS_TOL`` relative, both medians."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_global_batch
    from repro_torch.distributed import data_spec, distribute_tree, param_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init

    arch, b, s, steps = MESH_SSM
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    out = {}
    for sharded in (False, True):
        params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        m = mesh if sharded else None
        if sharded:
            params = distribute_tree(params, param_specs(params, mesh), mesh)
        opt = adamw_init(params)
        step_fn = make_train_step(cfg, m, remat=True, total_steps=TRAIN_STEPS)
        losses, ms = [], []
        for i in range(steps):
            raw = {k: v.cpu().numpy() for k, v in train_batch(cfg, seed, b, s, i).items()}
            batch = (make_global_batch(raw, mesh, data_spec(mesh, b), "cuda") if sharded
                     else {k: torch.from_numpy(v).cuda() for k, v in raw.items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step_fn(params, opt, batch)
            losses.append(float(met["ce"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[sharded] = (losses, statistics.median(ms[1:]))
        del params, opt
        free_memory(torch)
    (plain, plain_ms), (route, route_ms) = out[False], out[True]
    rel = max(abs(a - w) / abs(w) for a, w in zip(route, plain))
    print(f"[mesh] {arch} fp32 train step through mesh= (the Mamba2 layer under local_map, "
          f"rows and heads), batch {b} x {s}, remat, {steps} steps: losses "
          f"{', '.join(f'{x:.6f}' for x in route)} vs unsharded "
          f"{', '.join(f'{x:.6f}' for x in plain)}: max rel {rel:.2e} (tol {MESH_LOSS_TOL:g}); "
          f"median step {route_ms:.1f} ms vs unsharded {plain_ms:.1f} ms on {card}", flush=True)
    check(all(np.isfinite(route)), f"mesh: a {arch} loss is not finite")
    check(rel <= MESH_LOSS_TOL, f"mesh: {arch}'s mesh train losses differ from the unsharded")
    return {"arch": arch, "batch": b, "seq": s, "steps": steps, "losses": route,
            "unsharded_losses": plain, "max_rel": rel, "median_step_ms": route_ms,
            "unsharded_median_step_ms": plain_ms}


def phase_mesh(torch, seed: int, kernels: dict, card: str, unsharded_train: dict,
               unsharded_serve: dict) -> dict:
    """Phase 11: the mesh path at world 1 (one card). (a) an NCCL group of
    one and ``make_host_mesh``; (b) ``mesh_train``; (c) olmoe-1b-7b's paged
    decode step with ``mesh=`` (the MoE through ``local_map``) under the
    serve traffic, its first step held to the unsharded step's logits
    (``BF16_TOL`` relative L2, replayed routing), the median step beside
    phase 8's; (d) in ``mesh_train``, the int8 quantization; (e)
    ``mesh_decode``, the dense decode on the cache ``cache_specs`` places;
    (f) ``mesh_ssm_train``, the Mamba2 train step by rows and heads. The
    group is ended before it returns."""
    import torch.distributed as dist

    mesh = start_mesh(torch)
    plain_bwd = []
    try:
        print(f"[mesh] process group: {dist.get_backend()} world {dist.get_world_size()}, "
              f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on {card}", flush=True)
        with plain_backward_on_card(plain_bwd):
            train = mesh_train(torch, mesh, seed, kernels, card, unsharded_train)
            decode = mesh_decode(torch, mesh, seed, kernels, card)
            ssm = mesh_ssm_train(torch, mesh, seed, card)
        arch, n_req = MESH_SERVE
        cfg, params = load_model(torch, arch, seed, tag="[mesh]")
        serve = phase_serve(torch, cfg, params, seed, kernels, card, n_req,
                            tag=f"[mesh] {arch}", mesh=mesh)
        del params
        free_memory(torch)
    finally:
        dist.destroy_process_group()
    print(f"[mesh] {arch} decode, mesh route: median step {serve['median_step_ms']:.2f} ms vs "
          f"phase 8's unsharded {unsharded_serve['median_step_ms']:.2f} ms; paged launches "
          f"{serve['launches']['paged_attention']} through local_map on {card}", flush=True)
    print(f"[mesh] ref.flash_attention_bwd on a CUDA tensor in the mesh train steps: "
          f"{len(plain_bwd)} calls", flush=True)
    check(not plain_bwd, f"mesh: the plain backward ran on the card: {plain_bwd[:4]}")
    # flash through local_map: the train steps' and the dense decode's prefill (the
    # engine's prefill is unsharded)
    return {"train": train, "decode": decode, "ssm_train": ssm, "serve": serve, "launches": {
        "flash_attention": train["flash_launches"] + decode["launches"]["flash_attention"],
        "flash_attention_bwd": train["backward_launches"],
        "paged_attention": serve["launches"]["paged_attention"]},
        "plain_backward_on_card": len(plain_bwd)}


# ---------------------------------------------------------------------------
# phase 12: the tooling (serving bench, cost counter, dry run)
# ---------------------------------------------------------------------------

BENCH_ARCH = "qwen3-8b"      # the serving bench at its published size
BENCH_REQUESTS = 8           # serving_bench.run's traffic: 8 prompts of 16 tokens, 24 new
SERVE_POOL = (16, 4)         # phase 5's engine: sets, set size
SERVE_PAGE = 16              # phase 5's engine: tokens a page
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", "single"), ("olmoe-1b-7b", "decode_32k", "multi"),
                ("mamba2-780m", "train_4k", "single"))
# argument bytes a device of a decode cell when every rank held every row of the
# cache, its KV heads over model (the layout before ``cache_specs`` placed it),
# counted by ``launch.dryrun --device cpu`` at the same shapes
EVERY_ROW_ARGUMENT_BYTES = {("olmoe-1b-7b", "decode_32k", "multi"): 35_501_466_128}
DRYRUN_TIMEOUT_S = 600


def start_dryruns(out_dir: Path) -> list:
    """``DRYRUN_CELLS``, each ``python -m repro_torch.launch.dryrun ...
    --device cuda`` in a process of its own (a fake process group is
    process-global), all started at once: ((arch, shape, mesh), process,
    log)."""
    import os

    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])])}
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        log = out_dir / f"dryrun_{arch}_{shape}_{mesh}.log"
        with open(log, "w") as f:
            procs.append(((arch, shape, mesh), subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 shape, "--mesh", mesh, "--device", "cuda", "--out", str(out_dir)],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT), log))
    return procs


def finish_dryruns(procs: list, out_dir: Path, card: str) -> dict:
    """Waits for ``start_dryruns``' processes (killing any still running
    when one fails): each must exit 0; its per-device terms and trace
    time."""
    res = {}
    try:
        for (arch, shape, mesh), proc, log in procs:
            try:
                rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                rc = None
            check(rc == 0, f"tooling: the dry run of {arch} {shape} {mesh} exited {rc}: "
                  f"{log.read_text()[-2000:]}")
            rec = json.loads((out_dir / f"{arch}_{shape}_{mesh}.json").read_text())
            r = rec["roofline"]
            print(f"[tooling] dry run {arch} x {shape} x {mesh} (torch {rec['torch']}, "
                  f"{rec['chips']} fake ranks, the card's route: kernel calls "
                  f"{rec['kernel_calls']}): exit 0, trace {rec['trace_s']:.1f} s; per device "
                  f"{rec['flops_per_device']:.4e} FLOP, {rec['bytes_per_device']:.4e} B, "
                  f"collectives {rec['collectives']['total_bytes']:.4e} B "
                  f"{rec['collectives']['by_axis']}; derived H100 terms compute "
                  f"{r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} ms, "
                  f"collective {r['collective_s'] * 1e3:.3f} ms -> {r['bottleneck']}; useful-FLOP "
                  f"ratio {rec['useful_flop_ratio']:.4f}; args "
                  f"{rec['memory']['argument_bytes'] / 2 ** 30:.2f} GiB a device (not measured "
                  f"on {card})", flush=True)
            old = EVERY_ROW_ARGUMENT_BYTES.get((arch, shape, mesh))
            if old:
                print(f"[tooling] dry run {arch} x {shape} x {mesh}: memory {rec['memory']} "
                      f"(argument bytes {rec['memory']['argument_bytes']:,} with the cache by "
                      f"cache_specs, against {old:,} with every row on every rank)", flush=True)
                check(rec["memory"]["argument_bytes"] < old, f"tooling: the {arch} {shape} "
                      "decode cache is not cut below every row on every rank")
            res[f"{arch} {shape} {mesh}"] = rec
    finally:
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return res


def registration_host_us(torch, card: str) -> dict:
    """Host µs per call the operator registration adds: ``wrapper_host_us``
    of the paged (serve shape) and flash (qwen3-8b heads, S 512, bf16)
    wrappers called directly, and through their public entries (``ops.*``,
    the ``repro_torch`` operators; flash also through ``ops.flash_attention``,
    which without a gradient to record calls the operator alone),
    in turns (direct, operator, operator, direct)."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as paged_mod

    table, pool, lengths, _ = PAGED_TIMED["serve"]
    q, kp, vp, tab, lens = timed_paged_inputs(torch, np.random.default_rng(0), table, pool,
                                              lengths, 1)
    fq, fk, fv = (torch.randn(sh, device="cuda").to(torch.bfloat16)
                  for sh in ((1, 512, 32, 128), (1, 512, 8, 128), (1, 512, 8, 128)))
    calls = {
        "paged": (lambda: paged_mod.paged_attention(q, kp[0], vp[0], tab, lens),
                  lambda: ops.paged_attention(q, kp[0], vp[0], tab, lens)),
        "flash": (lambda: flash_mod.flash_attention(fq, fk, fv, causal=True),
                  lambda: torch.ops.repro_torch.flash_attention(fq, fk, fv, True, 0, 0.0, 0)),
    }
    out = {}
    for name, (direct, op) in calls.items():
        d1, o1, o2, d2 = (wrapper_host_us(torch, fn) for fn in (direct, op, op, direct))
        out[name] = {"direct_us": [d1, d2], "operator_us": [o1, o2],
                     "added_us": (o1 + o2 - d1 - d2) / 2}
    out["flash"]["function_us"] = wrapper_host_us(
        torch, lambda: ops.flash_attention(fq, fk, fv, causal=True))
    for name, t in out.items():
        print(f"[tooling] {name} host time a call: wrapper called directly "
              f"{t['direct_us'][0]:.2f} / {t['direct_us'][1]:.2f} us, through the repro_torch "
              f"operator {t['operator_us'][0]:.2f} / {t['operator_us'][1]:.2f} us: the "
              f"registration adds {t['added_us']:.2f} us"
              + (f" (ops.flash_attention, no gradient recorded: {t['function_us']:.2f} us)"
                 if name == "flash" else "") + f" on {card}", flush=True)
    del q, kp, vp, fq, fk, fv
    free_memory(torch)
    return out


def bench_flusher(torch, seed: int, kernels: dict, card: str) -> dict:
    """(a) ``benchmarks/serving_bench.run`` at ``BENCH_ARCH``'s published
    size, bf16, random weights from ``seed``: the same traffic with the
    flusher on and off (a pool of 4 sets x 3 pages of 8 tokens, so rows are
    preempted). Every request finishes, both runs emit the same tokens,
    both preempt, and the paged and flash kernels were launched."""
    from repro_torch.benchmarks import serving_bench

    zero_launches(kernels)
    r = serving_bench.run(BENCH_ARCH, full=True, device="cuda", weight_seed=seed,
                          out_dir=ROOT / "chiprun_out")
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    free_memory(torch)
    on, off = r["flusher_on"], r["flusher_off"]
    for name, st in (("on ", on), ("off", off)):
        print(f"[tooling] serving bench {BENCH_ARCH} ({r['config']['layers']} layers, bf16), "
              f"flusher {name}: {st['done']}/{BENCH_REQUESTS} done, blocking offloads "
              f"{st['blocking_offloads']}, clean evictions {st['clean_evictions']}, stale "
              f"discards {st['stale_discards']}, offloads {st['offloads']}, fetches "
              f"{st['fetches']}, preemptions {st['preemptions']}; {st['tokens_per_s']:.1f} "
              f"tokens/s, median decode step {st['median_step_ms']:.2f} ms over "
              f"{st['decode_steps']} steps on {card}", flush=True)
    print(f"[tooling] blocking offloads the flusher took off the critical path: "
          f"{r['blocking_offload_reduction']}; tokens identical: "
          f"{on['outputs'] == off['outputs']}; launches {launches}", flush=True)
    check(on["done"] == off["done"] == BENCH_REQUESTS,
          f"tooling: {on['done']} / {off['done']} of {BENCH_REQUESTS} requests finished")
    check(on["outputs"] == off["outputs"], "tooling: the flusher changed the emitted tokens")
    check(on["preemptions"] > 0 and off["preemptions"] > 0,
          "tooling: the serving bench preempted no row")
    check(launches["paged_attention"] > 0 and launches["flash_attention"] > 0,
          f"tooling: the serving bench did not launch both attention kernels: {launches}")
    return {**r, "launches": launches}


def roofline_ms(counter) -> dict:
    """A one-card count's derived terms (``dryrun.roofline``) in ms."""
    from repro_torch.launch import dryrun

    terms = dryrun.roofline(counter.flops, counter.memory_bytes, {})
    compute, memory = terms["compute_s"] * 1e3, terms["memory_s"] * 1e3
    return {"flops": counter.flops, "bytes": counter.memory_bytes, "compute_ms": compute,
            "memory_ms": memory, "bound_ms": max(compute, memory),
            "bound_by": "operations" if compute >= memory else "bytes",
            "kernel_calls": dict(counter.kernel_calls)}


def counted_steps(torch, card: str, train_full: dict, serve: dict) -> dict:
    """(b) ``launch/cost.py`` over two steps on fake tensors on the card, at
    world 1: tinyllama-1.1b's train step at phase 10's shape (remat, its
    microbatches) and qwen3-8b's paged decode step at phase 5's batch and
    active rows, its table as wide as the pages of phase 5's first step's
    longest row (fake lengths have no values, so the paged kernel's bytes
    count every row at the whole table). Each one's terms and bound beside
    the median that phase measured in this run. The train count must reach
    phase 10's model FLOPs and the decode count ``decode_step_bytes``'
    total, and the decode count must exceed that total by less than one
    layer's weights: short, or a layer's worth over, means the counter lost
    or invented work."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as S
    from repro_torch.launch.cost import CostMode
    from repro_torch.serving.paged_model import init_pools, make_paged_decode_step
    from repro_torch.tree import leaves

    b, s, mb = TRAIN_FULL_SHAPE
    cell = dryrun.count_cell("tinyllama-1.1b", ShapeConfig("phase10", s, b, "train"), None,
                             device="cuda", microbatches=mb)
    train = {**roofline_ms(cell["counter"]), "trace_s": cell["trace_s"],
             "measured_ms": train_full["median_step_ms"],
             "model_flops": train_full["model_flops_per_step"]}
    cfg = get_config(BENCH_ARCH)
    sets, ways = SERVE_POOL
    first = serve["first_step"]
    table = max(-(-(n + 1) // SERVE_PAGE) for n in first["lengths"])   # with the new key
    mode = FakeTensorMode()
    params = S.params_specs(cfg, "cuda", mode)
    with mode:
        pools = init_pools(cfg, num_pages=sets * ways + 1, page_size=SERVE_PAGE, max_batch=4,
                           device="cuda")
        i32 = dict(dtype=torch.int32, device="cuda")
        args = (params, pools, torch.empty((4, 1), **i32), torch.empty((4,), **i32),
                torch.empty((4, table), **i32),
                torch.empty((first["active_rows"],), dtype=torch.long, device="cuda"))
        t0 = time.perf_counter()
        with torch.no_grad(), CostMode() as counter:
            make_paged_decode_step(cfg, page_size=SERVE_PAGE)(*args)
        trace_s = time.perf_counter() - t0
    decode = {**roofline_ms(counter), "trace_s": trace_s,
              "measured_ms": serve["median_step_ms"], "table_pages": table,
              "step_bytes": sum(serve["step_bytes"].values()),
              "layer_weight_bytes": sum(t.numel() * t.element_size()
                                        for t in leaves(params["blocks"])) // cfg.n_layers}
    out = {"train": train, "decode": decode}
    for name, t in out.items():
        t["measured_over_bound"] = t["measured_ms"] / t["bound_ms"]
        print(f"[tooling] counted {name} step on fake tensors on the card ({t['trace_s']:.1f} s "
              f"to trace): {t['flops']:.4e} FLOP, {t['bytes']:.4e} B, kernel calls "
              f"{t['kernel_calls']}; derived terms compute {t['compute_ms']:.3f} ms, memory "
              f"{t['memory_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms by {t['bound_by']}; "
              f"measured median {t['measured_ms']:.2f} ms in this run = "
              f"{t['measured_over_bound']:.2f}x the bound on {card}", flush=True)
    print(f"[tooling] train count {train['flops']:.4e} FLOP vs phase 10's model FLOPs "
          f"{train['model_flops']:.4e}; decode count {decode['bytes']:.4e} B (table of "
          f"{table} pages) vs decode_step_bytes {decode['step_bytes']:.4e} B: over by "
          f"{decode['bytes'] - decode['step_bytes']:.4e} B, one layer's weights "
          f"{decode['layer_weight_bytes']:.4e} B", flush=True)
    check(train["flops"] >= train["model_flops"],
          "tooling: the train step's count is below its model FLOPs")
    check(decode["bytes"] >= decode["step_bytes"],
          "tooling: the decode step's count is below decode_step_bytes")
    check(decode["bytes"] - decode["step_bytes"] < decode["layer_weight_bytes"],
          "tooling: the decode step's count exceeds decode_step_bytes by a layer's weights")
    return out


def phase_tooling(torch, seed: int, kernels: dict, card: str, train_full: dict,
                  serve: dict) -> dict:
    """Phase 12: the operator registration's host time and (a)
    ``bench_flusher``, both timed on the host with no other process of
    this run busy; then (c) the dry-run cells start in their own processes,
    (b) ``counted_steps`` runs beside them (it times nothing), and (c) waits
    for the dry runs."""
    out_dir = ROOT / "chiprun_out" / "dryrun_torch"
    host = registration_host_us(torch, card)
    bench = bench_flusher(torch, seed, kernels, card)
    procs = start_dryruns(out_dir)
    try:
        counted = counted_steps(torch, card, train_full, serve)
    finally:
        dry = finish_dryruns(procs, out_dir, card)
    return {"registration_host_us": host, "bench": bench, "counted": counted, "dryrun": dry,
            "launches": bench["launches"]}


# ---------------------------------------------------------------------------
# phase 13: the trace bridge into the SSD-array simulator
# ---------------------------------------------------------------------------

TRACE_DIR = ROOT / "build" / "traces"


def phase_trace(torch, seed: int, kernels: dict, card: str, ckpt: dict) -> dict:
    """Phase 13: the port's page IO as traces for the SSD-array simulator
    (``serving/trace_shim.py``, ``serving/fleet.py``). (a) ``run_fleet`` at
    ``FleetConfig()`` and ``seed``: the rows, ``trace_digest`` and seconds;
    (b) ``ckpt``, the trace that ``attach_ckpt`` recorded of phase 10's
    final save of the trained tinyllama-1.1b and its optimizer state (the
    ``CheckpointManager``'s ``ckpt_trace``): one write row a chunk, the
    digest and the save ms. Both traces go to ``build/traces/*.npz``.
    Nothing here runs on the card and no kernel launches; the replay's GC
    numbers are simulator output, not card numbers, and are not run here."""
    from repro_torch.serving.fleet import FleetConfig, run_fleet
    from repro_torch.serving.trace_shim import save_trace, trace_digest

    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    zero_launches(kernels)
    t0 = time.perf_counter()
    fleet = run_fleet(FleetConfig(), seed=seed)
    fleet_s = time.perf_counter() - t0
    save_trace(TRACE_DIR / f"fleet_seed{seed}.npz", fleet.trace, meta=fleet.meta)
    out = {"fleet": {"rows": len(fleet.trace), "digest": trace_digest(fleet.trace),
                     "seconds": fleet_s, "offloads": fleet.offloads, "fetches": fleet.fetches,
                     "stale_discards": fleet.stale_discards,
                     "dirty_evictions": fleet.dirty_evictions}}
    print(f"[trace] run_fleet(FleetConfig(), seed={seed}): {out['fleet']['rows']} rows in "
          f"{fleet_s:.2f} s (offloads {fleet.offloads}, fetches {fleet.fetches}, stale discards "
          f"{fleet.stale_discards}, blocking spills {fleet.dirty_evictions}); trace_digest "
          f"{out['fleet']['digest']}", flush=True)
    check(len(fleet.trace) > 0, "trace: the fleet emitted no row")

    trace = ckpt.pop("trace")
    save_trace(TRACE_DIR / "ckpt_tinyllama-1.1b.npz", trace, meta={"n_targets": ckpt["n_targets"]})
    out["ckpt"] = {**ckpt, "rows": len(trace), "digest": trace_digest(trace)}
    launches = read_launches(kernels)
    print(f"[trace] attach_ckpt on phase 10's CheckpointManager, its final save of "
          f"tinyllama-1.1b's trained state ({ckpt['bytes'] / 1e9:.2f} GB, {ckpt['chunks']} "
          f"chunks): {len(trace)} rows, save_async {ckpt['save_ms']:.0f} ms, the writes pumped "
          f"and committed in {ckpt['write_ms']:.0f} ms; trace_digest {out['ckpt']['digest']}; "
          f"traces in {TRACE_DIR.relative_to(ROOT)}/; launches {launches} on {card}", flush=True)
    check(len(trace) == ckpt["chunks"],
          f"trace: {len(trace)} rows for {ckpt['chunks']} checkpoint chunks")
    return {**out, "launches": launches}


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each function in an nvcc ``-Xptxas -v`` log."""
    funcs, cur = {}, None
    for line in log.splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            cur = m.group(1)
            funcs.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            funcs[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            funcs[cur]["registers"] = int(m.group(1))
    return funcs


def build_all(torch, modules: dict) -> dict:
    """Build every kernel library at once, one nvcc each; print each one's
    time and its registers and spills. Fails if the wgmma flash kernel, a
    set-design flush kernel or any attention backward kernel spills."""
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
        for line in _build.build_logs.get(name, "(no nvcc report)").splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"[build]   {line.strip()}")
    wgmma = {f: r for f, r in ptxas_report(_build.build_logs.get("flash_attention", "")).items()
             if "flash_wgmma_kernel" in f}
    print(f"[build] wgmma flash kernels: {wgmma}", flush=True)
    check(len(wgmma) == 2, "build: no nvcc report for both wgmma flash kernels (hd 64, 128)")
    check(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
              for r in wgmma.values()), "build: the wgmma flash kernel spills registers")
    flush = ptxas_report(_build.build_logs.get("flush_score", ""))
    sets = {f: r for f, r in flush.items() if "flush_set_kernel" in f}
    print(f"[build] flush kernels: {flush}", flush=True)
    check(len(sets) == 2 * FLUSH_SET_MAX, f"build: {len(sets)} set-design flush kernels in the "
          f"nvcc report, not {2 * FLUSH_SET_MAX} (set sizes 1-16, aligned or not)")
    check(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
              for r in sets.values()), "build: a set-design flush kernel spills registers")
    bwd = {f: r for f, r in ptxas_report(_build.build_logs.get("flash_attention_bwd", "")).items()
           if "_kernel" in f}
    print(f"[build] attention backward kernels: {bwd}", flush=True)
    # dot x 2 dtypes; wgmma dkv and dq x 2 (hd 64; 120 and 128 as 128 columns); simt dkv
    # and dq x 7 (dtype, head dim)
    check(len(bwd) == 2 + 2 * 2 + 2 * 7, f"build: {len(bwd)} attention backward kernels in "
          "the nvcc report, not 20")
    check(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
              for r in bwd.values()), "build: an attention backward kernel spills registers")
    return {"seconds": seconds, "wgmma_ptxas": wgmma, "flush_ptxas": flush, "backward_ptxas": bwd}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    probes = ap.add_mutually_exclusive_group()
    probes.add_argument("--decode-probe", metavar="SRC",
                        help="only time the paged kernel's decode (decode_probe) with the port "
                             "package found under SRC, print it as one JSON line and exit")
    probes.add_argument("--backward-probe", metavar="SRC",
                        help="only check and time the attention backward "
                             "(time_attention_backward) with the port package found under SRC, "
                             "print it as one JSON line and exit")
    probes.add_argument("--mesh-probe", metavar="SRC",
                        help="only time phase 11's mesh train and decode steps (mesh_probe) "
                             "with the port package found under SRC, print them as one JSON "
                             "line and exit")
    probes.add_argument("--flush-probe", metavar="SRC",
                        help="only time the flush kernel (flush_probe) with the port package "
                             "found under SRC, print it as one JSON line and exit")
    args = ap.parse_args()
    probe_src = args.decode_probe or args.flush_probe or args.backward_probe or args.mesh_probe
    if probe_src:
        sys.path.insert(0, str(Path(probe_src).resolve()))

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
    if probe_src is None:     # an earlier package under SRC may have no backward kernel
        from repro_torch.kernels import flash_attention_bwd as flash_bwd_mod

        kernels["flash_attention_bwd"] = flash_bwd_mod.flash_attention_bwd
    if probe_src:
        probe = (decode_probe if args.decode_probe else flush_probe if args.flush_probe
                 else backward_probe if args.backward_probe
                 else lambda torch, seed, card: mesh_probe(torch, seed, card, kernels))
        try:
            print(json.dumps(probe(torch, args.seed, card)), flush=True)
        except SmokeFailure as e:
            print(f"chip_smoke FAILED: {e}", file=sys.stderr)
            return 1
        return 0

    try:
        # 2. build
        build = timed("build", build_all, torch, {
            "paged_attention": paged_mod, "flash_attention": flash_mod, "flush_score": flush_mod,
            "flash_attention_bwd": flash_bwd_mod})
        # 3. kernels
        paged = timed("kernels: paged", phase_kernels, torch, args.seed, card)
        flash = timed("kernels: flash", phase_flash, torch, args.seed, card)
        flash_bwd = timed("kernels: flash backward", phase_flash_bwd, torch, args.seed, card)
        flush = timed("kernels: flush", phase_flush, torch, args.seed, card)
        # 4-8. the paths
        exact = timed("exact", phase_exact, torch, args.seed, kernels)
        exact_families = {arch: timed(f"exact {arch}", phase_exact, torch, args.seed, kernels,
                                      arch) for arch in EXACT_FAMILIES}
        cfg, params = load_model(torch, "qwen3-8b", args.seed)
        serve = timed("serve", phase_serve, torch, cfg, params, args.seed, kernels, card)
        prefill = timed("prefill", phase_prefill, torch, cfg, params, args.seed, kernels, card)
        del params
        free_memory(torch)
        sa = timed("sa-cache", phase_sa_cache, torch, args.seed, kernels, card)
        families = timed("families", phase_families, torch, args.seed, kernels, card)
        # 9. encoder-decoder and vision
        encdec = timed("encdec, vision", phase_encdec_vision, torch, args.seed, kernels, card)
        # 10. training
        train = timed("train", phase_train, torch, args.seed, kernels, card)
        # 11. the mesh path
        mesh = timed("mesh", phase_mesh, torch, args.seed, kernels, card, train["full"],
                     families[MESH_SERVE[0]])
        # 12. the tooling
        tooling = timed("tooling", phase_tooling, torch, args.seed, kernels, card,
                        train["full"], serve)
        # 13. the trace bridge
        trace = timed("trace", phase_trace, torch, args.seed, kernels, card,
                      train["full"].pop("ckpt_trace"))
        free_memory(torch)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    def family_launches(name: str) -> dict:
        return {"exact_families_launches": {a: n[name] for a, n in exact_families.items()},
                "families_phase_launches": {a: r["launches"][name] for a, r in families.items()},
                "encdec_vision_launches": {run: n[name] for run, n in encdec["launches"].items()}}

    common = {"route": "cuda", "library_ms": None}
    serve_t = paged["timed"]["serve"]
    line = {"kernels": [
        {**common, "name": "paged_attention",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:74",
         "launches": serve["launches"]["paged_attention"],
         "combine_launches": serve["launches"]["paged_combine"],
         "splits_launched": serve["launches"]["paged_splits"],
         "max_abs_err": max(paged["max_err_fp32"], paged["max_err_bf16"]),
         **{k: serve_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "eager_ms", "wrapper_host_us", "plan")},
         "library": "page gather + scaled_dot_product_attention(enable_gqa=True)",
         "long_shapes": {name: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "plan", "lengths", "table",
                                                  "max_abs_err", "rel_l2", "wrapper_host_us")}
                         for name, t in paged["timed"].items() if name != "serve"},
         "cases": paged["cases"], "max_err_fp32": paged["max_err_fp32"],
         "max_err_bf16": paged["max_err_bf16"], "max_rel_l2_fp32": paged["max_rel_l2_fp32"],
         "max_rel_l2_bf16": paged["max_rel_l2_bf16"],
         "exact_phase_launches": exact["paged_attention"],
         "prefill_phase_launches": prefill["launches"]["paged_attention"],
         "prefill_decode_step_median_ms": prefill["decode_step_median_ms"],
         "prefill_decode_paged_device_ms_per_step": prefill["decode_paged_device_ms_per_step"],
         **family_launches("paged_attention"),
         "mesh_phase_launches": mesh["launches"]["paged_attention"],
         "tooling_phase_launches": tooling["launches"]["paged_attention"],
         "registration_host_us": tooling["registration_host_us"]["paged"]},
        {**common, "name": "flash_attention",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:84",
         "launches": prefill["launches"]["flash_attention"],
         "max_abs_err": max(flash["max_err_fp32"], flash["max_err_bf16"]),
         "launches_by_design": prefill["launches_by_design"]["flash_attention"],
         "ms": flash["ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
         "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
         "library": flash["library"], "tflops": flash["tflops"],
         "cases": flash["cases"], "max_err_fp32": flash["max_err_fp32"],
         "max_err_bf16": flash["max_err_bf16"], "gemma2_swa": flash["gemma2_swa"],
         "serve_phase_launches": serve["launches"]["flash_attention"],
         "exact_phase_launches": exact["flash_attention"], "ttft_ms": prefill["ttft_ms"],
         **family_launches("flash_attention"),
         "train_phase_launches": train["flash_launches"],
         "mesh_phase_launches": mesh["launches"]["flash_attention"],
         "tooling_phase_launches": tooling["launches"]["flash_attention"],
         "registration_host_us": tooling["registration_host_us"]["flash"]},
        {**common, "name": "flash_attention_bwd",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/models/layers.py:109",
         "replaces_note": "no TPU kernel: JAX's gradient is XLA's autodiff of _dense_attention",
         "launches": train["full"]["launches"]["flash_attention_bwd"],
         "launches_by_design": train["full"]["backward_designs"],
         "max_abs_err": max(flash_bwd["max_err_fp32"], flash_bwd["max_err_bf16"]),
         **{k: train["attention_backward"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library", "function_ms",
             "autograd_plain_ms", "shape", "flops", "kernel_ms")},
         "qwen3_8b_shape": {k: train["attention_backward"]["qwen3_8b"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "function_ms", "shape",
             "flops", "kernel_ms", "grad_rel_l2")},
         "wgmma_ptxas": flash_bwd["wgmma_ptxas"],
         "cases": flash_bwd["cases"], "max_err_fp32": flash_bwd["max_err_fp32"],
         "max_err_bf16": flash_bwd["max_err_bf16"],
         "max_rel_l2_fp32": flash_bwd["max_rel_l2_fp32"],
         "max_rel_l2_bf16": flash_bwd["max_rel_l2_bf16"],
         "train_phase_launches": train["backward_launches"],
         "mesh_phase_launches": mesh["launches"]["flash_attention_bwd"],
         "plain_backward_on_card": train["plain_backward_on_card"]
         + mesh["plain_backward_on_card"]},
        {**common, "name": "flush_scores",
         "source": "src/repro_torch/kernels/csrc/flush_score.cu",
         "replaces": "src/repro/kernels/flush_score.py:50",
         "launches": sa["launches"]["flush_scores"], "max_abs_err": flush["max_err"],
         "launches_by_design": sa["launches_by_design"],
         **{k: flush[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "view_ms",
                                  "copies")},
         "library": "none", "cases": flush["cases"],
         "long_shapes": {name: t for name, t in flush["shapes"].items() if name != "131072x12"},
         **family_launches("flush_scores")},
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build": build, "kernels": line["kernels"], "flash_bwd": flash_bwd,
         "serve": serve,
         "prefill": prefill, "families": families, "encdec_vision": encdec,
         "sa_cache": sa, "exact_launches": exact, "exact_families_launches": exact_families,
         "train": train, "mesh": mesh, "tooling": tooling, "trace": trace,
         "phase_seconds": PHASE_SECONDS}, indent=1, default=str))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
