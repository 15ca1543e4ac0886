"""The port's CUDA kernels on the card: kernel == plain version, the serving
engine through the kernels == dense decode with plain attention, and the
SA-cache twin on the card == on the CPU. Skips without a card.

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports nothing of JAX, so it runs on a machine that has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import sa_cache
from repro_torch.kernels import flash_attention as cuda_flash
from repro_torch.kernels import flush_score as cuda_flush
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as cuda_paged
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine

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
]
TOLS = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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
    want = ref.paged_attention_ref(*args, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=TOLS[dtype], rtol=TOLS[dtype])


@pytest.mark.parametrize("dtype", list(TOLS))
def test_kernel_length_zero_gives_zero(card, dtype):
    args = _inputs((5, 4, 2, 16, 8, 4, 16), getattr(torch, dtype), seed=9,
                   lengths=[0, 1, 8, 9, 32])
    out = ops.paged_attention(*args)
    assert torch.all(out[0] == 0)
    torch.testing.assert_close(out.float(), ref.paged_attention_ref(*args).float(),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


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
    before = cuda_flush.flush_scores.launches
    got = sa_cache.select_flush_candidates(on_card, 6, 2)
    assert cuda_flush.flush_scores.launches == before + 1
    for g, w in zip(got, sa_cache.select_flush_candidates(state, 6, 2)):
        assert torch.equal(g.cpu(), w)


def test_engine_through_kernel_matches_dense_decode(card, monkeypatch):
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), card)
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3,
                      device=card)
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 250, int(rng.integers(3, 20)))]
               for _ in range(6)]
    rids = [eng.submit(p, max_new=24) for p in prompts]
    before = (cuda_paged.paged_attention.launches, cuda_flash.flash_attention.launches)
    eng.run(800)
    eng.close()
    assert cuda_paged.paged_attention.launches > before[0]
    assert cuda_flash.flash_attention.launches >= before[1] + cfg.n_layers * len(prompts)
    assert eng.stats()["preemptions"] > 0
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
