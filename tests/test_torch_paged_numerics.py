"""The plan of the split-K paged kernel (``kernels/csrc/paged_attention.cu``),
rehearsed on the CPU.

``_split_k_rehearsal`` repeats the kernel's arithmetic in plain PyTorch: the
table cut into splits of whole pages by the wrapper's ``_plan_splits``; per
split an online softmax (m, l, acc) in f32 over tiles of ``TILE_KEYS`` keys
in the log2 domain (q scaled by hd**-0.5 * log2(e); with a softcap: scale,
cap * tanh(s / cap), times log2(e)); a split that one block holds whole
writes the output itself; otherwise the partials are merged in split
order. It is held to the port's plain version and to the JAX Pallas kernel
in interpret mode on the same numpy inputs, in fp32 at 2e-5. With
``mma=True`` it follows the bf16 body instead (4 softmax states per split,
8 keys of each tile apiece, P rounded to bf16, merged in warp order), held
to both at the card tests' bf16 tolerance, 3e-2. The properties of
``_plan_splits`` are checked with hypothesis.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import (BLOCKS_PER_SM, MAX_GROUP, MAX_SPLIT_PAGES,
                                                 TILE_KEYS, _plan_splits)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = 2e-5
BF16_TOL = 3e-2           # the card tests' bf16 tolerance
LOG2E = math.log2(math.e)
H100_SMS = 132


def _softmax_step(state, x, vt, round_p):
    """One online-softmax step of (m, l, acc) over scores x (..., n) in the
    log2 domain; a state that has seen no key keeps m = -inf."""
    m, l, acc = state
    m_new = torch.maximum(m, x.amax(dim=-1))
    m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
    corr = torch.exp2(m - m_use)
    p = torch.exp2(x - m_use[..., None])
    if round_p:                   # the mma body feeds p.v with P in bf16, and sums that P
        p = p.to(torch.bfloat16).float()
    return m_new, l * corr + p.sum(dim=-1), acc * corr[..., None] + torch.einsum(
        "grn,ngd->grd", p, vt)


def _merge(states):
    """(m, l, acc) of several states, merged in order."""
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    m_use = torch.where(mx == -math.inf, torch.zeros_like(mx), mx)
    lsum, o = torch.zeros_like(mx), torch.zeros_like(states[0][2])
    for m, l, acc in states:
        c = torch.exp2(m - m_use)
        lsum = lsum + l * c
        o = o + acc * c[..., None]
    return mx, lsum, o


def _split_k_rehearsal(q, k_pages, v_pages, table, lengths, *, softcap=0.0, sm_count=H100_SMS,
                       mma=False):
    """The kernel's plan in plain PyTorch; returns (out, splits per row that
    hold keys, number of splits). ``mma=False`` is the f32 body (one softmax
    step per tile of ``TILE_KEYS`` keys); ``mma=True`` the bf16 body (each
    of 4 warps keeps its own softmax over its 8 keys of every tile, P is
    rounded to bf16, the warps are merged in order at the split's end)."""
    b, h, hd = q.shape
    _, page, kvh, _ = k_pages.shape
    max_pages = table.shape[1]
    group = h // kvh
    per, n_splits = _plan_splits(b, kvh, group, max_pages, page, sm_count)
    split_keys = per * page
    q_scale = hd ** -0.5 * (1.0 if softcap else LOG2E)
    lanes = TILE_KEYS // 4 if mma else TILE_KEYS        # keys of a tile per softmax state
    out = torch.empty((b, h, hd))
    live = []
    for row in range(b):
        length = min(max(int(lengths[row]), 0), max_pages * page)
        n_live = max(1, -(-length // split_keys))
        live.append(n_live)
        qg = q[row].float().reshape(kvh, group, hd)
        parts = []
        for s in range(n_live):
            k0, k_end = s * split_keys, min((s + 1) * split_keys, length)
            states = [(torch.full((kvh, group), -math.inf), torch.zeros((kvh, group)),
                       torch.zeros((kvh, group, hd))) for _ in range(TILE_KEYS // lanes)]
            for t0 in range(k0, k_end, TILE_KEYS):
                for w in range(len(states)):
                    lo, hi = t0 + w * lanes, min(t0 + (w + 1) * lanes, k_end)
                    if lo >= hi:          # none of this state's keys is live
                        continue
                    keys = torch.arange(lo, hi)
                    pids = table[row, keys // page].long()
                    kt = k_pages[pids, keys % page].float()      # (n, KV, hd)
                    vt = v_pages[pids, keys % page].float()
                    x = torch.einsum("grd,ngd->grn", qg, kt) * q_scale
                    if softcap:
                        x = softcap * LOG2E * torch.tanh(x / softcap)
                    states[w] = _softmax_step(states[w], x, vt, mma)
            parts.append(_merge(states))
        if n_live == 1:                     # the block wrote the output itself
            _, l, o = parts[0]
        else:                               # the combine, in split order
            _, l, o = _merge(parts)
        out[row] = (o / l.clamp(min=1e-30)[..., None]).reshape(h, hd)
    return out.to(q.dtype), live, n_splits


def _inputs(case, seed, lengths=None, dtype=np.float32):
    b, h, kv, hd, page, maxp, pool = case
    rng = np.random.default_rng(seed)
    arrays = {
        "q": rng.normal(size=(b, h, hd)).astype(dtype),
        "k": rng.normal(size=(pool, page, kv, hd)).astype(dtype),
        "v": rng.normal(size=(pool, page, kv, hd)).astype(dtype),
        "table": rng.integers(0, pool, size=(b, maxp)).astype(np.int32),
        "lengths": np.asarray(rng.integers(1, maxp * page, size=(b,)) if lengths is None
                              else lengths, np.int32),
    }
    return arrays, {k: tensor_from_numpy(a) for k, a in arrays.items()}


def _check_against_both(case, seed, lengths=None, softcap=0.0, sm_count=H100_SMS, mma=False):
    """The rehearsal (f32, or the bf16 body's plan on bf16 inputs) held to
    the plain version and the interpret-mode Pallas kernel."""
    a, t = _inputs(case, seed, lengths, dtype=jnp.bfloat16 if mma else np.float32)
    tol = BF16_TOL if mma else TOL
    got, live, n_splits = _split_k_rehearsal(t["q"], t["k"], t["v"], t["table"], t["lengths"],
                                             softcap=softcap, sm_count=sm_count, mma=mma)
    assert torch.isfinite(got).all() and got.shape == t["q"].shape
    assert got.dtype == (torch.bfloat16 if mma else torch.float32)
    want = ref.paged_attention_ref(t["q"], t["k"], t["v"], t["table"], t["lengths"],
                                   softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    pallas = jax_paged(*(jnp.asarray(a[k]) for k in ("q", "k", "v", "table", "lengths")),
                       softcap=softcap, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32), atol=tol,
                               rtol=tol)
    return got, live, n_splits


PAGED_CASES = [
    # b, h, kv, hd, page, max_pages, pool  (tests/test_kernels.py)
    (4, 8, 2, 64, 16, 8, 64),
    (2, 4, 4, 128, 32, 4, 16),
    (3, 6, 6, 32, 8, 16, 128),
    (1, 16, 8, 64, 64, 4, 8),
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("sm_count", [1, H100_SMS])
def test_split_k_plan_matches_ref_and_pallas(case, sm_count):
    _, _, n_splits = _check_against_both(case, seed=PAGED_CASES.index(case), sm_count=sm_count)
    if sm_count == H100_SMS:        # small batches: the table is cut
        assert n_splits > 1


def test_split_k_plan_softcap():
    _, live, _ = _check_against_both((2, 4, 2, 32, 8, 12, 32), seed=11, lengths=[5, 90],
                                     softcap=30.0)
    assert live[1] > 1


EDGE_CASE = (6, 4, 2, 16, 8, 12, 64)     # 3 splits of 4 pages (32 keys) on an H100


def test_edge_case_plan():
    b, h, kv, _, page, maxp, _ = EDGE_CASE
    assert _plan_splits(b, kv, h // kv, maxp, page, H100_SMS) == (4, 3)


@pytest.mark.parametrize("name,lengths,live", [
    ("zero-one-edges", [0, 1, 32, 33, 96, 95], [1, 1, 1, 2, 3, 3]),
    ("past-the-row", [2, 31, 64, 65, 40, 7], [1, 1, 2, 3, 2, 1]),
])
def test_split_edges(name, lengths, live):
    """Length 0 and 1, a split's last key (32), one past it, the table's end
    (96); splits that lie wholly past a row's length hold nothing."""
    got, got_live, n_splits = _check_against_both(EDGE_CASE, seed=12, lengths=lengths)
    assert n_splits == 3 and got_live == live
    zero = [i for i, n in enumerate(lengths) if n == 0]
    assert all(torch.all(got[i] == 0) for i in zero)


@pytest.mark.parametrize("case,lengths,softcap", [
    (EDGE_CASE, [0, 1, 32, 33, 96, 63], 0.0),
    (EDGE_CASE, [0, 1, 32, 33, 96, 63], 50.0),
    ((2, 32, 8, 120, 16, 6, 24), [33, 96], 0.0),      # hd 120: read as 128 wide on the card
    ((2, 32, 4, 64, 16, 24, 96), [300, 383], 0.0),    # tinyllama heads (group 8), 6 splits
])
def test_mma_body_bf16_plan_matches_ref_and_pallas(case, lengths, softcap):
    """The bf16 body's plan: 4 softmax states per split (8 keys of each tile
    apiece), P in bf16, merged in warp order, then the splits in order."""
    got, live, _ = _check_against_both(case, seed=14, lengths=lengths, softcap=softcap, mma=True)
    assert max(live) > 1
    assert all(torch.all(got[i] == 0) for i, n in enumerate(lengths) if n == 0)


def test_split_k_head_dim_120():
    """h2o-danube's heads (H 32, KV 8, hd 120, page 16), 3 splits of 32 keys."""
    case = (2, 32, 8, 120, 16, 6, 24)
    assert _plan_splits(2, 8, 4, 6, 16, H100_SMS) == (2, 3)
    _, live, _ = _check_against_both(case, seed=13, lengths=[33, 96])
    assert live == [2, 3]


def test_plan_at_the_timed_shapes():
    """qwen3-8b's decode heads on an H100: decode-4k launches at least 264
    blocks; the serving shape keeps a row (under 96 keys) in one split."""
    per, n = _plan_splits(4, 8, 4, 264, 16, H100_SMS)
    assert n * 4 * 8 >= 2 * H100_SMS and per * n >= 264
    per, n = _plan_splits(1, 8, 4, 2048, 16, H100_SMS)
    assert n * 8 >= 2 * H100_SMS
    per, _ = _plan_splits(4, 8, 4, 64, 16, H100_SMS)
    assert per * 16 >= 72


@settings(max_examples=300, deadline=None)
@given(batch=st.integers(1, 64), kv=st.integers(1, 16), group=st.integers(1, 20),
       max_pages=st.integers(1, 5000), page=st.sampled_from([1, 3, 8, 16, 32, 64, 256]),
       sms=st.integers(1, 264))
def test_plan_splits_properties(batch, kv, group, max_pages, page, sms):
    per, n = _plan_splits(batch, kv, group, max_pages, page, sms)
    assert n >= 1 and 1 <= per <= min(MAX_SPLIT_PAGES, max_pages)
    # whole pages; every table page covered exactly once, in order
    pages = [p for s in range(n) for p in range(s * per, min((s + 1) * per, max_pages))]
    assert pages == list(range(max_pages))
    assert (n - 1) * per < max_pages                 # no split starts past the table
    tile_pages = max(1, TILE_KEYS // page)
    if max_pages >= tile_pages:                      # whole tiles where a page is shorter
        assert per % tile_pages == 0
    base = batch * kv * -(-group // MAX_GROUP)
    want = -(-BLOCKS_PER_SM * sms // base)
    if max_pages >= tile_pages * want:               # a long table reaches the target
        assert n * base >= BLOCKS_PER_SM * sms
    # shapes only: the same shapes give the same plan
    assert _plan_splits(batch, kv, group, max_pages, page, sms) == (per, n)


def test_long_context_check_catches_a_dropped_split():
    """chip_smoke's check at decode-4k: with N(0,1) inputs the softmax is
    nearly flat and outputs are about 1/sqrt(4,098), so a merge that drops
    the last of a row's 10 splits (66 keys) stays inside the elementwise
    tolerance; the relative L2 bound rejects it and passes bf16 rounding."""
    per, _ = _plan_splits(4, 8, 4, 264, 16, H100_SMS)       # decode-4k's plan
    split_keys, length = per * 16, 4098
    n_live = -(-length // split_keys)
    _, t = _inputs((1, 4, 1, 128, 16, 264, 264), seed=15, lengths=[length])
    t["table"] = torch.arange(264, dtype=torch.int32)[None]
    want = ref.paged_attention_ref(t["q"], t["k"], t["v"], t["table"], t["lengths"])
    dropped = ref.paged_attention_ref(t["q"], t["k"], t["v"], t["table"],
                                      torch.tensor([(n_live - 1) * split_keys], dtype=torch.int32))
    assert n_live == 10 and (dropped - want).abs().max() < BF16_TOL
    assert not chip_smoke.paged_close(torch, dropped, want, BF16_TOL,
                                      chip_smoke.PAGED_REL_L2_BF16)[0]
    assert chip_smoke.paged_close(torch, want.to(torch.bfloat16), want, BF16_TOL,
                                  chip_smoke.PAGED_REL_L2_BF16)[0]
