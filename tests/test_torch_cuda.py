"""The port's CUDA kernels on the card: kernel == plain version, the serving
engine through the kernels == dense decode with plain attention, and the
SA-cache twin on the card == on the CPU. Skips without a card.

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports nothing of JAX, so it runs on a machine that has none.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import sa_cache
from repro_torch.kernels import flash_attention as cuda_flash
from repro_torch.kernels import flash_attention_bwd as cuda_flash_bwd
from repro_torch.kernels import flush_score as cuda_flush
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as cuda_paged
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine
from repro_torch.serving.paged_model import init_pools, make_paged_decode_step

pytestmark = pytest.mark.cuda

PAGED_CASES = [
    # b, h, kv, hd, page, max_pages, pool
    (4, 8, 2, 64, 16, 8, 64),
    (2, 4, 4, 128, 32, 4, 16),
    (3, 6, 6, 32, 8, 16, 128),
    (1, 16, 8, 64, 64, 4, 8),
    (4, 32, 8, 128, 16, 64, 65),      # qwen3-8b decode
    (2, 4, 2, 16, 8, 4, 16),          # reduced configs (hd 16)
    (2, 32, 8, 120, 16, 8, 32),       # h2o-danube decode (hd 120)
    (4, 16, 16, 128, 16, 8, 64),      # olmoe-1b-7b decode (group 1)
    (4, 16, 8, 64, 16, 8, 64),        # granite-moe-1b-a400m decode (group 2)
    (4, 64, 8, 128, 16, 8, 64),       # qwen2-vl-72b decode (group 8 at hd 128)
]
TOLS = {"float32": 2e-5, "bfloat16": 3e-2}
# and relative L2 over the whole output (chip_smoke.py's, which says why)
REL_L2_TOLS = {"float32": 2e-5, "bfloat16": 1e-2}

# chip_smoke.py keeps the split-K plan's edge cases; they are run here too
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
SPLIT_CASES = chip_smoke.SPLIT_CASES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_paged_close(out, want, dtype):
    torch.testing.assert_close(out.float(), want.float(), atol=TOLS[dtype], rtol=TOLS[dtype])
    diff = (out.float() - want.float()).norm()
    assert diff <= REL_L2_TOLS[dtype] * want.float().norm(), "relative L2 error too large"


def _inputs(case, dtype, seed, lengths=None):
    b, h, kv, hd, page, maxp, pool = case
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)

    table = torch.from_numpy(rng.integers(0, pool, size=(b, maxp)).astype(np.int32)).cuda()
    if lengths is None:
        lengths = rng.integers(1, maxp * page, size=(b,))
    return (t(b, h, hd), t(pool, page, kv, hd), t(pool, page, kv, hd), table,
            torch.tensor(np.asarray(lengths, np.int32)).cuda())


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_kernel_matches_plain_version(card, case, dtype, softcap):
    args = _inputs(case, getattr(torch, dtype), seed=PAGED_CASES.index(case))
    before = cuda_paged.paged_attention.launches
    out = ops.paged_attention(*args, softcap=softcap)
    torch.cuda.synchronize()
    assert cuda_paged.paged_attention.launches == before + 1
    _assert_paged_close(out, ref.paged_attention_ref(*args, softcap=softcap), dtype)


def test_kernel_call_under_capture_counts_as_captured(card):
    """A call made while a CUDA graph is captured launches nothing and
    counts in ``captured``, not in ``launches``; the replay computes what
    an eager call does."""
    args = _inputs(PAGED_CASES[0], torch.float32, seed=0)
    fn = cuda_paged.paged_attention
    ops.paged_attention(*args)                  # the build, outside the capture
    torch.cuda.synchronize()
    before = (fn.launches, fn.captured["launches"])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.paged_attention(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert (fn.launches, fn.captured["launches"]) == (before[0], before[1] + 1)
    _assert_paged_close(out, ref.paged_attention_ref(*args), "float32")


@pytest.mark.parametrize("dtype", list(TOLS))
def test_kernel_length_zero_gives_zero(card, dtype):
    args = _inputs((5, 4, 2, 16, 8, 4, 16), getattr(torch, dtype), seed=9,
                   lengths=[0, 1, 8, 9, 32])
    out = ops.paged_attention(*args)
    assert torch.all(out[0] == 0)
    _assert_paged_close(out, ref.paged_attention_ref(*args), dtype)


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_split_kernel_edges_match_plain_version(card, case, dtype, softcap):
    b, h, kv, _, page, maxp, _ = case
    lengths = chip_smoke.split_edge_lengths(case)
    _, n_splits = cuda_paged._plan_splits(b, kv, h // kv, maxp, page, cuda_paged._sm_count(0))
    args = _inputs(case, getattr(torch, dtype), seed=SPLIT_CASES.index(case), lengths=lengths)
    fn = cuda_paged.paged_attention
    before = (fn.launches, fn.combine_launches, fn.splits)
    out = ops.paged_attention(*args, softcap=softcap)
    again = ops.paged_attention(*args, softcap=softcap)
    torch.cuda.synchronize()
    assert n_splits > 1 and fn.last_plan["splits"] == n_splits
    assert (fn.launches, fn.combine_launches, fn.splits) == (
        before[0] + 2, before[1] + 2, before[2] + 2 * n_splits)
    assert torch.equal(out, again), "two runs on the same inputs differ"
    assert torch.all(out[0] == 0)
    _assert_paged_close(out, ref.paged_attention_ref(*args, softcap=softcap), dtype)


def test_paged_kernel_in_a_cuda_graph_takes_new_lengths(card):
    """The wrapper never reads lengths on the host: a captured call replayed
    with new lengths gives the plain version's result for them."""
    q, k, v, table, lengths = _inputs((4, 32, 8, 128, 16, 64, 300), torch.bfloat16, seed=21,
                                      lengths=[5, 70, 300, 1000])
    ops.paged_attention(q, k, v, table, lengths)          # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.paged_attention(q, k, v, table, lengths)
    for new in ([0, 1, 1023, 17], [1024, 512, 33, 64], [96, 97, 95, 1]):
        lengths.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _assert_paged_close(out, ref.paged_attention_ref(q, k, v, table, lengths), "bfloat16")


def test_paged_kernel_at_decode_4k(card):
    """qwen3-8b's decode over 4,096-4,104-key contexts (B 4, table 264), each
    row's pages distinct in the pool, bf16 at 3e-2 and 1e-2 relative L2
    (outputs are about 0.026 there, so the elementwise bound alone is loose)."""
    rng = np.random.default_rng(22)
    b, h, kv, hd, page, maxp = 4, 32, 8, 128, 16, 264
    table = torch.from_numpy(rng.permutation(b * maxp).reshape(b, maxp).astype(np.int32)).cuda()
    q, k, v, _, lengths = _inputs((b, h, kv, hd, page, maxp, b * maxp), torch.bfloat16,
                                  seed=22, lengths=rng.integers(4096, 4105, size=b))
    out = ops.paged_attention(q, k, v, table, lengths)
    assert cuda_paged.paged_attention.last_plan["blocks"] >= 2 * cuda_paged._sm_count(0)
    _assert_paged_close(out, ref.paged_attention_ref(q, k, v, table, lengths), "bfloat16")


FLASH_CASES = [
    # b, sq, skv, h, kv, hd, causal, window, softcap, q_offset
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, 0),      # tests/test_kernels.py FLASH_CASES
    (1, 256, 256, 8, 8, 64, True, 64, 50.0, 0),
    (2, 64, 192, 4, 1, 128, False, 0, 0.0, 0),
    (1, 100, 100, 2, 2, 32, True, 0, 0.0, 0),
    (1, 16, 144, 6, 6, 64, True, 0, 0.0, 0),
    (3, 128, 128, 8, 4, 16, True, 32, 0.0, 0),
    (1, 16, 64, 4, 4, 32, True, 0, 0.0, 48),       # q_offset tail
    (1, 300, 300, 32, 8, 120, True, 4096, 0.0, 0),  # h2o-danube (hd 120, window 4096)
    (1, 300, 300, 4, 2, 120, True, 70, 0.0, 0),    # hd 120, tiles skipped by the window
    (1, 520, 520, 32, 8, 128, True, 0, 0.0, 0),    # qwen3-8b heads
    (1, 8, 16, 2, 1, 16, True, 4, 0.0, 16),        # rows with no key give 0
    (1, 512, 512, 16, 16, 128, True, 0, 0.0, 0),   # olmoe-1b-7b prefill heads (group 1)
    (1, 512, 512, 16, 8, 64, True, 0, 0.0, 0),     # granite-moe-1b-a400m prefill heads
    (4, 1500, 1500, 6, 6, 64, False, 0, 0.0, 0),   # whisper-tiny encoder (1,500 frames)
    (4, 4, 1500, 6, 6, 64, False, 0, 0.0, 0),      # whisper-tiny cross-attention
    (1, 1088, 1088, 64, 8, 128, True, 0, 0.0, 0),  # qwen2-vl-72b vision prefill (group 8)
]
FLASH_TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(FLASH_TOLS))
def test_flash_kernel_matches_plain_version(card, case, dtype):
    b, sq, skv, h, kv, hd, causal, window, cap, q_offset = case
    rng = np.random.default_rng(FLASH_CASES.index(case))

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(
            getattr(torch, dtype))

    q, k, v = t(b, sq, h, hd), t(b, skv, kv, hd), t(b, skv, kv, hd)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    before = cuda_flash.flash_attention.launches
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert cuda_flash.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=FLASH_TOLS[dtype],
                               rtol=FLASH_TOLS[dtype])


RAGGED = (1, 63, 64, 65, 127, 129, 1000)     # both sides of the 64- and 128-row tiles
WGMMA_CASES = [
    # b, sq, skv, h, kv, hd, causal, window, softcap, q_offset
    *[(1, sq, skv, 4, 2, 128, causal, 0, 0.0, 0)
      for sq in RAGGED for skv in RAGGED for causal in (True, False)],
    (1, 127, 1000, 8, 2, 128, True, 0, 0.0, 873),     # q_offset tail: rows at 873..999
    (1, 1000, 1000, 4, 2, 128, True, 100, 0.0, 0),    # window not a multiple of the tile
    (1, 1000, 1000, 4, 2, 128, True, 0, 50.0, 0),     # softcap 50 (gemma2)
    (1, 1000, 1000, 4, 2, 128, True, 100, 50.0, 0),   # gemma2's sliding layer: both
    (1, 130, 200, 4, 2, 128, True, 4, 0.0, 197),      # rows 6.. have no valid key
    *[(1, 300, 300, 8, kv, 128, True, 0, 0.0, 0) for kv in (8, 4, 2, 1)],   # GQA 1, 2, 4, 8
    (3, 300, 300, 8, 2, 128, True, 0, 0.0, 0),        # B 3
    (2, 300, 300, 4, 2, 64, True, 0, 0.0, 0),         # hd 64 (tinyllama)
    (2, 1000, 1000, 4, 2, 64, True, 100, 50.0, 0),
    (2, 300, 300, 4, 2, 120, True, 0, 0.0, 0),        # hd 120 (h2o-danube)
    (1, 1000, 1000, 4, 1, 120, True, 100, 0.0, 0),
]


def _flash_inputs(case, dtype, seed):
    b, sq, skv, h, kv, hd = case[:6]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)

    return t(b, sq, h, hd), t(b, skv, kv, hd), t(b, skv, kv, hd)


def _flash_run(case, dtype, seed):
    """Two launches on the same inputs, held to the plain version; returns
    the launches of each design they made and the first output."""
    causal, window, cap, q_offset = case[6:]
    q, k, v = _flash_inputs(case, dtype, seed)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    before = dict(cuda_flash.flash_attention.launches_by_design)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    made = {d: cuda_flash.flash_attention.launches_by_design[d] - before[d] for d in before}
    again = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "two runs on the same inputs differ"
    tol = FLASH_TOLS[str(dtype)[6:]]
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
                               atol=tol, rtol=tol)
    return made, out


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_wgmma_kernel_matches_plain_version(card, case):
    made, out = _flash_run(case, torch.bfloat16, seed=WGMMA_CASES.index(case))
    assert made == {"wgmma": 1, "simt": 0}
    if case[7] == 4:                                  # the rows with no valid key
        assert torch.all(out[:, 6:] == 0) and torch.all(out[:, :6] != 0)


@pytest.mark.parametrize("case,dtype", [((2, 129, 129, 4, 2, 128, True, 0, 0.0, 0), "float32"),
                                        ((2, 129, 129, 4, 2, 32, True, 0, 0.0, 0), "bfloat16")])
def test_flash_simt_kernel_takes_fp32_and_small_heads(card, case, dtype):
    made, _ = _flash_run(case, getattr(torch, dtype), seed=7)
    assert made == {"wgmma": 0, "simt": 1}


@pytest.mark.parametrize("ns,ss", [(100, 12), (1000, 12), (64, 7), (513, 16), (1, 12),
                                   (256, 2), (37, 64), (2100, 12), (131072, 12)])
def test_flush_kernel_matches_plain_version(card, ns, ss):
    rng = np.random.default_rng(ns + ss)
    hits = torch.from_numpy(rng.integers(0, 15, size=(ns, ss)).astype(np.int32)).cuda()
    clock = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(ns,)).astype(np.int32)).cuda()
    valid = torch.from_numpy(rng.random((ns, ss)) > 0.3).cuda()
    before = cuda_flush.flush_scores.launches
    out = ops.flush_scores(hits, clock, valid)
    torch.cuda.synchronize()
    assert cuda_flush.flush_scores.launches == before + 1
    assert torch.equal(out, ref.flush_scores_ref(hits, clock, valid))


FLUSH_EDGE_CASES = ([(ns, ss, False) for ns, ss in chip_smoke.FLUSH_GRID]
                    + [(ns, ss, True) for ns, ss in chip_smoke.FLUSH_VIEWS])


@pytest.mark.parametrize("ns,ss,view", FLUSH_EDGE_CASES)
def test_flush_kernel_on_int32_edges(card, ns, ss, view):
    """chip_smoke.py's grid: the int32 edges of the arithmetic, every set
    size of the set design, blocks of 128 sets short, whole and past, the
    slot design, and views [1:] that are not 16-byte aligned (staged
    through shared memory); each launched as the design its set size takes."""
    hits, clock, valid = chip_smoke.flush_case(torch, ns, ss, np.random.default_rng(ns * ss),
                                               view)
    kind = "set" if ss <= chip_smoke.FLUSH_SET_MAX else "slot"
    before = dict(cuda_flush.flush_scores.launches_by_design)
    out = ops.flush_scores(hits, clock, valid)
    again = ops.flush_scores(hits, clock, valid)
    torch.cuda.synchronize()
    made = {d: n - before[d] for d, n in cuda_flush.flush_scores.launches_by_design.items()}
    assert made == {"set": 2 * (kind == "set"), "slot": 2 * (kind == "slot")}
    assert torch.equal(out, ref.flush_scores_ref(hits, clock, valid))
    assert torch.equal(out, again)


@pytest.mark.parametrize("ss,kind", [(1, "set"), (12, "set"), (16, "set"), (17, "slot"),
                                     (256, "slot")])
def test_flush_kernel_launches_by_design(card, ss, kind):
    hits, clock, valid = chip_smoke.flush_case(torch, 300, ss, np.random.default_rng(ss))
    fn = cuda_flush.flush_scores
    before = (fn.launches, dict(fn.launches_by_design))
    ops.flush_scores(hits, clock, valid)
    assert fn.launches == before[0] + 1
    assert {d: n - before[1][d] for d, n in fn.launches_by_design.items()} == {
        d: int(d == kind) for d in fn.launches_by_design}


def test_flush_kernel_in_a_cuda_graph_takes_new_inputs(card):
    """The set design reads nothing on the host: a captured call replayed
    with new hits, clocks and valid bits gives the plain version's scores."""
    rng = np.random.default_rng(23)
    hits, clock, valid = chip_smoke.flush_case(torch, 1000, 12, rng)
    ops.flush_scores(hits, clock, valid)                 # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.flush_scores(hits, clock, valid)
    for _ in range(3):
        for dst, src in zip((hits, clock, valid), chip_smoke.flush_case(torch, 1000, 12, rng)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref.flush_scores_ref(hits, clock, valid))


def test_select_flush_candidates_on_card_equals_cpu(card):
    rng = np.random.default_rng(5)
    ns, ss = 4096, 12
    valid = rng.random((ns, ss)) > 0.2
    state = sa_cache.CacheState(
        tags=torch.from_numpy(np.where(valid, np.arange(ns * ss).reshape(ns, ss), -1)
                              .astype(np.int32)),
        hits=torch.from_numpy(rng.integers(0, 16, size=(ns, ss)).astype(np.int32)),
        dirty=torch.from_numpy((rng.random((ns, ss)) > 0.4) & valid),
        clock=torch.from_numpy(rng.integers(0, ss, size=(ns,)).astype(np.int32)))
    on_card = sa_cache.CacheState(*(None if x is None else x.cuda() for x in state))
    before = (cuda_flush.flush_scores.launches, cuda_flush.flush_scores.launches_by_design["set"])
    got = sa_cache.select_flush_candidates(on_card, 6, 2)
    assert cuda_flush.flush_scores.launches == before[0] + 1
    assert cuda_flush.flush_scores.launches_by_design["set"] == before[1] + 1
    for g, w in zip(got, sa_cache.select_flush_candidates(state, 6, 2)):
        assert torch.equal(g.cpu(), w)


def test_engine_through_kernel_matches_dense_decode(card, monkeypatch):
    """The engine's decode step, one CUDA graph replayed each step, emits
    dense greedy decode's tokens under pool pressure. The paged kernel's
    wrapper is called only while the engine is built: its warm-ups launch
    the kernel, and its capture records one call per layer into the graph,
    which each replay launches."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), card)
    fn = cuda_paged.paged_attention
    before = (fn.launches, fn.captured["launches"], cuda_flash.flash_attention.launches)
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3,
                      device=card)
    built = fn.launches
    assert built > before[0]
    assert fn.captured["launches"] - before[1] == cfg.n_layers
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 250, int(rng.integers(3, 20)))]
               for _ in range(6)]
    rids = [eng.submit(p, max_new=24) for p in prompts]
    eng.run(800)
    eng.close()
    assert fn.launches == built and fn.captured["launches"] - before[1] == cfg.n_layers
    assert cuda_flash.flash_attention.launches >= before[2] + cfg.n_layers * len(prompts)
    st = eng.stats()
    assert st["preemptions"] > 0
    assert st["decode_graph_replays"] == st["decode_steps"] > 0
    # the reference prefills with the plain attention in the kernel's place
    monkeypatch.setattr(ops, "flash_attention", ref.flash_attention_ref)
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            last, cache = T.prefill(params, torch.tensor([p], device=card), cfg, max_seq=128)
            t = last[:, -1].argmax(-1)[:, None]
            want = []
            for _ in range(24):
                want.append(int(t[0, 0]))
                lg, cache = T.decode_step(params, t, cache, cfg)
                t = lg[:, -1].argmax(-1)[:, None]
            assert eng.result(rid).out == want


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device, copy=True)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m", "jamba-v0.1-52b"])
def test_moe_and_mamba_step_on_card_match_cpu(card, arch):
    """One paged decode step of a reduced MoE, Mamba2 or hybrid model in fp32
    on the card (the paged kernel, cuBLAS) equals the same step on the CPU
    (plain attention) within 2e-5: logits, K/V and mamba state; the MoE
    routing of the step's inputs is identical."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    pools = init_pools(cfg, num_pages=13, page_size=8, max_batch=4)
    gen = torch.Generator().manual_seed(1)
    for p in pools:
        for a in p.values():
            a.copy_(torch.randn(a.shape, generator=gen) * 0.5)
    table = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    args = (torch.tensor([[3], [4], [5], [6]]), torch.tensor([5, 20, 0, 9], dtype=torch.int32),
            table, torch.tensor([True, True, False, True]))
    step = make_paged_decode_step(cfg, page_size=8)
    card_pools = _to(pools, card)
    got = step(_to(params, card), card_pools, *_to(args, card))
    want = step(params, pools, *args)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)
    for p, cp in zip(pools, card_pools):
        for k in p:
            torch.testing.assert_close(cp[k].cpu(), p[k], atol=2e-5, rtol=2e-5)
    if cfg.moe_experts:
        i = next(i for i, spec in enumerate(cfg.block) if spec.ffn == "moe")
        moe = T.layer_params(params["blocks"][i]["moe"], 0)
        x = torch.randn((4 * 16, cfg.d_model), generator=gen)
        _, idx, _ = M.route(x, moe, cfg)
        _, card_idx, _ = M.route(x.to(card), _to(moe, card), cfg)
        assert torch.equal(card_idx.cpu(), idx)


def test_preempted_mamba_state_waits_in_host_memory(card):
    """Deviation (a) on the card: a preempted row's mamba state is kept in
    host memory, and the resumed request's tokens are dense greedy decode's."""
    cfg = reduced(get_config("mamba2-780m"))
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), card)
    eng = ServeEngine(cfg, params, max_batch=2, page_size=8, num_sets=8, set_size=2,
                      device=card)
    prompt = [5, 7, 11, 13, 17]
    rid = eng.submit(prompt, max_new=8)
    eng.step()
    eng.step()
    req = eng.result(rid)
    eng._preempt(req)
    assert all(a.device.type == "cpu" for st in req.mamba_state.values() for a in st.values())
    eng._waiting.append(rid)
    eng.run(50)
    eng.close()
    st = eng.stats()
    assert st["decode_graph_replays"] == st["decode_steps"] > 0
    with torch.no_grad():
        last, cache = T.prefill(params, torch.tensor([prompt], device=card), cfg, max_seq=128)
        t = last[:, -1].argmax(-1)[:, None]
        want = []
        for _ in range(8):
            want.append(int(t[0, 0]))
            lg, cache = T.decode_step(params, t, cache, cfg)
            t = lg[:, -1].argmax(-1)[:, None]
    assert req.state == "done" and req.out == want


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b", "gemma2-27b", "qwen2-vl-72b"])
def test_engine_graph_step_matches_eager_step(card, arch):
    """One replay of the engine's captured step equals the eager step on
    the same params, pools and inputs within 2e-5 in fp32: logits, every
    pool page but the sink, mamba state; an inactive row's state stays."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), card)
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3,
                      max_pages=3, device=card)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for p in eng.pools:
        for a in p.values():
            a.copy_(torch.randn(a.shape, generator=gen, device=card) * 0.5)
    eng._last_tok[:] = [3, 4, 5, 6]
    eng._lengths[:] = [5, 20, 2 * 8 * 3, 9]        # row 2: inactive, past its table
    eng._tables[:] = np.arange(12, dtype=np.int32).reshape(4, 3)
    eng._active[:] = [True, True, False, True]
    pools = _to(eng.pools, card)
    want = make_paged_decode_step(cfg, page_size=8)(
        params, pools, *(t.to(card) for t in eng._inputs))
    before = _to(eng.pools, card)
    got = eng.step_fn(eng.params, eng.pools, *eng._inputs).clone()
    eng.close()
    assert eng.stats()["decode_graph_replays"] == 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    for spec, p, w, b in zip(cfg.block, eng.pools, pools, before):
        for k, a in p.items():
            if spec.kind == "attn":
                torch.testing.assert_close(a[:, :12], w[k][:, :12], atol=2e-5, rtol=2e-5)
            else:
                torch.testing.assert_close(a, w[k], atol=2e-5, rtol=2e-5)
                assert torch.equal(a[:, 2], b[k][:, 2])


def test_engine_graph_step_refuses_other_params_and_a_closed_engine(card):
    """The graph reads the params and pools it was captured over: the
    engine's step refuses others, and refuses to run once the engine is
    closed and its graph released."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), card)
    eng = ServeEngine(cfg, params, max_batch=2, page_size=8, num_sets=4, set_size=3,
                      device=card)
    with pytest.raises(ValueError):
        eng.step_fn(dict(eng.params), eng.pools, *eng._inputs)
    with pytest.raises(ValueError):
        eng.step_fn(eng.params, list(eng.pools), *eng._inputs)
    eng.step_fn(eng.params, eng.pools, *eng._inputs)
    eng.close()
    with pytest.raises(RuntimeError):
        eng.step_fn(eng.params, eng.pools, *eng._inputs)
    assert eng.stats()["decode_graph_replays"] == 1


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_encdec_and_vision_models_on_card_match_cpu(card, arch):
    """Reduced whisper-tiny (its encoder and cross-attention through the
    flash kernel, non-causal, Sq != Skv) and qwen2-vl-72b (M-RoPE, patch
    embeddings) in fp32: prefill and two decode steps on the card equal the
    CPU's (plain attention) within 2e-5, the cross K/V too."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 14)))
    if cfg.encoder_layers:
        kw = {"enc_frames": torch.from_numpy(
            rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}
    else:
        kw = {"vis_embeds": torch.from_numpy(
            rng.normal(size=(2, cfg.vis_tokens, cfg.d_model)).astype(np.float32))}
    card_params = _to(params, card)
    before = cuda_flash.flash_attention.launches
    got, cache = T.prefill(card_params, toks[:, :12].to(card), cfg, max_seq=16, **_to(kw, card))
    want, ccache = T.prefill(params, toks[:, :12], cfg, max_seq=16, **kw)
    # the encoder's layers, then self- and cross-attention in each decoder layer
    launches = cfg.encoder_layers + (2 if cfg.encoder_layers else 1) * cfg.n_layers
    assert cuda_flash.flash_attention.launches == before + launches
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)
    if cfg.encoder_layers:
        for k in ("k", "v"):
            torch.testing.assert_close(cache.cross[k].cpu(), ccache.cross[k], atol=2e-5,
                                       rtol=2e-5)
    for t in (12, 13):
        got, cache = T.decode_step(card_params, toks[:, t:t + 1].to(card), cache, cfg)
        want, ccache = T.decode_step(params, toks[:, t:t + 1], ccache, cfg)
        torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the flash kernel under autograd (training)
# ---------------------------------------------------------------------------

GRAD_CASES = [
    # b, sq, skv, h, kv, hd, causal, window, softcap, q_offset
    (2, 512, 512, 32, 4, 64, True, 0, 0.0, 0),      # tinyllama-1.1b heads
    (2, 1300, 1300, 8, 2, 64, True, 0, 0.0, 0),     # causal over 3 key chunks, ragged
    (1, 256, 256, 8, 8, 64, True, 64, 50.0, 0),     # window and softcap
    (1, 16, 64, 4, 4, 32, True, 0, 0.0, 48),        # q_offset tail
    (2, 64, 192, 4, 1, 128, False, 0, 0.0, 0),      # Sq != Skv, group 4
    (2, 4, 1500, 6, 6, 64, False, 0, 0.0, 0),       # whisper-tiny cross-attention
    (1, 130, 200, 4, 2, 128, True, 4, 0.0, 197),    # rows 6.. have no valid key
    # chip_smoke.py's grid for the backward kernel, at every head dim
    *[(b, sq, skv, h, kv, hd, causal, window, cap, q_offset)
      for b, sq, skv, h, kv, causal, window, cap, q_offset in chip_smoke.FLASH_BWD_CASES
      for hd in chip_smoke.FLASH_BWD_HEAD_DIMS],
]
GRAD_REL_L2 = {"float32": 2e-5, "bfloat16": 1e-2}


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("dtype", list(GRAD_REL_L2))
def test_flash_function_forward_backward_on_card(card, case, dtype):
    """``ops.flash_attention`` under autograd on the card: one forward kernel
    launch, held to the plain version, and one backward kernel launch
    (``flash_attention_bwd``), each of the design the input takes; dq, dk,
    dv equal autograd through the plain version on the same inputs
    (relative L2 fp32 2e-5, bf16 1e-2); a row with no valid key gets zero
    gradient."""
    causal, window, cap, q_offset = case[6:]
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    dt = getattr(torch, dtype)
    hd = case[5]
    q, k, v = (x.requires_grad_() for x in _flash_inputs(case, dt, seed=GRAD_CASES.index(case)))
    do = torch.randn(q.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(1)).to(dt)
    kind = "wgmma" if dt == torch.bfloat16 and hd in chip_smoke.WGMMA_HEAD_DIMS else "simt"
    before = dict(cuda_flash.flash_attention.launches_by_design)
    bwd_before = dict(cuda_flash_bwd.flash_attention_bwd.launches_by_design)
    out = ops.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    made = {n: c - before[n] for n, c in cuda_flash.flash_attention.launches_by_design.items()}
    bwd_made = {n: c - bwd_before[n]
                for n, c in cuda_flash_bwd.flash_attention_bwd.launches_by_design.items()}
    assert made == {"wgmma": 0, "simt": 0, kind: 1}
    assert bwd_made == {"wgmma": 0, "simt": 0, kind: 1}
    want_out = ref.flash_attention_ref(q, k, v, **kw)
    wants = torch.autograd.grad(want_out, (q, k, v), do)
    tol = FLASH_TOLS[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    for g, w in zip(grads, wants):
        assert g.dtype == dt and _rel_l2(g, w) <= GRAD_REL_L2[dtype]
    if window == 4:
        assert torch.all(grads[0][:, 6:] == 0)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-tiny"])
def test_train_step_gradient_on_card_matches_cpu(card, arch):
    """The train step's gradient (remat, 2 microbatches) of reduced fp32
    models on the card (flash kernel forward, the Function's backward)
    equals the CPU's (JAX's dense attention) within 1e-5 relative L2 per
    leaf, every leaf nonzero; the kernel launches once per attention call
    forward and once more in each block's recompute (whisper's encoder is
    not rematerialised, as in JAX)."""
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.tree import leaves

    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, size=(4, 33))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.encoder_layers:
        batch["enc_frames"] = torch.from_numpy(
            rng.normal(size=(4, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    grad_fn = make_grad_fn(cfg, remat=True, microbatches=2)
    want, wm = grad_fn(params, batch)
    before = cuda_flash.flash_attention.launches
    got, gm = grad_fn(_to(params, card), _to(batch, card))
    torch.cuda.synchronize()
    per_fwd = (2 if cfg.encoder_layers else 1) * cfg.n_layers
    assert cuda_flash.flash_attention.launches - before == 2 * (cfg.encoder_layers + 2 * per_fwd)
    assert abs(float(gm["ce"]) - float(wm["ce"])) <= 1e-5 * float(wm["ce"])
    for g, w in zip(leaves(got), leaves(want)):
        assert float(g.abs().max()) > 0 and _rel_l2(g.cpu(), w) <= 1e-5
