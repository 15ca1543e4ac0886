"""The attention backward kernel's plan (``kernels/csrc/flash_attention_bwd.cu``)
rehearsed on the CPU, where no CUDA kernel runs.

``_mirror_bwd`` is the kernel's plan in plain PyTorch: its tile sizes, read
from the ``.cu``'s ``constexpr`` lines (``_build.kernel_constants``), the
``simt`` design's for the fp32 plan and the ``wgmma`` design's for the bf16
plan; the same tile bounds (the query tiles a key tile visits, the key
tiles a query tile visits, and in ``wgmma`` the tiles each consumer
warpgroup's 64 rows see inside its block's); P = exp(s - lse) from the
forward's ``lse``; D = rowsum(do * out); dK/dV summed over the heads of a
group and the query tiles, dQ over the key tiles, in f32; and, for the
``wgmma`` design, P and dS rounded to bf16 before their products. It is
held to ``ref.flash_attention_bwd`` and to ``jax.vjp`` of JAX's attention
(``repro.models.layers._dense_attention``,
or ``repro.kernels.ref.flash_attention_ref`` where a row has no valid key),
on inputs from numpy: fp32 plan within 2e-5, bf16 plan within 1e-2
relative L2 (``chip_smoke.py``'s ``TRAIN_ATTN_GRAD_TOL``). Every pair the
masks leave valid must lie in a tile the plan visits. Also: the plain
``lse`` against ``jax.nn.logsumexp`` of JAX's masked scores, the two new
operators by ``torch.library.opcheck``, and the ``FlashAttention``
Function through both operators on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models import layers as JL
from repro_torch.kernels import _build, flash_attention, flash_attention_bwd, ops, ref
from repro_torch.launch import cost
from test_torch_train import ATTN_CASES

# keys of a dK/dV block, queries of its inner tile; queries of a dQ block,
# keys of its inner tile: the kernel's own constexpr lines, by design. A
# wgmma block's keys (dK/dV) or rows (dQ) are split among consumer
# warpgroups of WG_ROWS, each skipping the tiles its own rows do not see.
_NAMES = ("kv_keys", "kv_queries", "q_rows", "q_keys")
TILES = {"simt": dict(zip(_NAMES, _build.kernel_constants(
             "flash_attention_bwd", "kKvKeys", "kKvQueries", "kQRows", "kQKeys"))),
         "wgmma": dict(zip(_NAMES, _build.kernel_constants(
             "flash_attention_bwd", "kWgKvKeys", "kWgKvQueries", "kWgQRows", "kWgQKeys")))}
WG_ROWS = {"simt": None, "wgmma": 64}
PLAN_DESIGN = {"fp32": "simt", "bf16": "wgmma"}
F32_TOL = 2e-5
BF16_REL_L2 = 1e-2

CASES = {
    **ATTN_CASES,
    # b, sq, skv, h, kv, hd, causal, window, softcap, q_offset
    "ragged_tiles": (2, 100, 150, 4, 2, 16, False, 0, 0.0, 0),
    "ragged_causal": (1, 130, 130, 4, 2, 32, True, 0, 0.0, 0),
    "narrow_window_q_offset": (1, 70, 200, 4, 2, 16, True, 5, 0.0, 130),
    "window_softcap_tiles": (1, 150, 150, 4, 2, 16, True, 40, 30.0, 0),
    "gqa_1": (1, 80, 80, 2, 2, 16, True, 0, 0.0, 0),
    "gqa_2": (1, 80, 80, 4, 2, 16, True, 0, 0.0, 0),
    "gqa_8": (1, 80, 80, 8, 1, 16, True, 0, 0.0, 0),
    # the wgmma tiles' edges: Skv ragged at the 128-key block, Sq not a
    # multiple of the 64-query tile or the 128-row block, GQA 8 with q_offset
    "ragged_wg_keys": (1, 90, 200, 4, 2, 16, False, 0, 0.0, 0),
    "ragged_wg_causal": (1, 200, 200, 2, 1, 16, True, 0, 0.0, 0),
    "gqa_8_q_offset": (1, 70, 260, 8, 1, 16, True, 0, 0.0, 190),
}


def _inputs(case, seed=0, bf16=False):
    b, sq, skv, h, kv, hd = case[:6]
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=shape).astype(np.float32)
          for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd), (b, sq, h, hd))]
    if bf16:     # values a bf16 tensor holds, kept in f32 for both packages
        xs = [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
    return xs


def _kw(case):
    causal, window, softcap, q_offset = case[6:]
    return dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)


def _mask(sq, skv, causal, window, q_offset):
    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _kv_query_rows(k0, nk, sq, causal, window, q_offset):
    """The .cu's ``query_rows``: rows [lo, hi] that see a key of [k0, k0 + nk)."""
    lo = max(0, k0 - q_offset) if causal else 0
    hi = sq - 1
    if window:
        hi = min(hi, k0 + nk - 2 + window - q_offset)
    return lo, max(hi, -1)


def _q_key_cols(q0, nq, skv, causal, window, q_offset):
    """The .cu's ``key_cols``: keys [lo, hi) that a row of [q0, q0 + nq) sees."""
    hi = min(skv, q0 + nq + q_offset) if causal else skv
    lo = max(0, q0 + q_offset - window + 1) if window else 0
    return lo, hi


def _mirror_bwd(q, k, v, out, lse, do, *, causal, window, softcap, q_offset, design):
    """(dq, dk, dv) in f32 by the kernel's plan of ``design``, and the (Sq,
    Skv) pairs its dK/dV and dQ tiles visit. q, out, do: (B, Sq, H, hd); k,
    v: (B, Skv, KV, hd); lse: (B, H, Sq); all f32 tensors."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = hd ** -0.5
    tiles, wg = TILES[design], WG_ROWS[design]
    rnd = (lambda x: x.bfloat16().float()) if design == "wgmma" else (lambda x: x)
    heads = lambda x: x.reshape(b, sq, kvh, rep, hd).permute(0, 2, 3, 1, 4)  # (B, KV, rep, Sq, hd)
    qh, doh = heads(q), heads(do)
    dsum = (do * out).sum(-1).reshape(b, sq, kvh, rep).permute(0, 2, 3, 1)  # (B, KV, rep, Sq)
    lseh = lse.reshape(b, kvh, rep, sq)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)                  # (B, KV, Skv, hd)
    mask = _mask(sq, skv, causal, window, q_offset)

    def p_ds(s, dp, rows, cols, lse_t, d_t):
        x = s * scale
        if softcap:
            t = torch.tanh(x / softcap)
            x = softcap * t
        p = torch.where(mask[rows, cols], torch.exp(x - lse_t[..., None]), torch.zeros(()))
        ds = p * (dp - d_t[..., None])
        return p, ds * (1 - t * t) if softcap else ds

    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    seen_kv = torch.zeros((sq, skv), dtype=torch.bool)
    nq = tiles["kv_queries"]
    for k0 in range(0, skv, tiles["kv_keys"]):
        stop = min(k0 + tiles["kv_keys"], skv)
        lo, hi = _kv_query_rows(k0, stop - k0, sq, causal, window, q_offset)
        for g0 in range(k0, stop, wg or stop - k0):     # the block's consumer warpgroups
            cols = slice(g0, min(g0 + (wg or stop - k0), stop))
            w_lo, w_hi = _kv_query_rows(g0, cols.stop - g0, sq, causal, window, q_offset)
            for r in range(rep if lo <= hi else 0):
                for t in range(lo // nq, hi // nq + 1):
                    if not w_lo // nq <= t <= (w_hi // nq if w_lo <= w_hi else -1):
                        continue
                    rows = slice(t * nq, min((t + 1) * nq, sq))
                    qt, dot = qh[:, :, r, rows], doh[:, :, r, rows]
                    p, ds = p_ds(qt @ kh[:, :, cols].transpose(-1, -2),
                                 dot @ vh[:, :, cols].transpose(-1, -2), rows, cols,
                                 lseh[:, :, r, rows], dsum[:, :, r, rows])
                    dv[:, :, cols] += rnd(p).transpose(-1, -2) @ dot
                    dk[:, :, cols] += rnd(ds).transpose(-1, -2) @ qt
                    seen_kv[rows, cols] = True

    dq = torch.zeros_like(qh)
    seen_q = torch.zeros((sq, skv), dtype=torch.bool)
    nk = tiles["q_keys"]
    for q0 in range(0, sq, tiles["q_rows"]):
        stop = min(q0 + tiles["q_rows"], sq)
        lo, hi = _q_key_cols(q0, stop - q0, skv, causal, window, q_offset)
        for g0 in range(q0, stop, wg or stop - q0):     # the block's consumer warpgroups
            rows = slice(g0, min(g0 + (wg or stop - q0), stop))
            w_lo, w_hi = _q_key_cols(g0, rows.stop - g0, skv, causal, window, q_offset)
            for kv0 in range(lo // nk * nk, hi, nk):
                if not (kv0 < w_hi and kv0 + nk > w_lo):
                    continue
                cols = slice(kv0, min(kv0 + nk, skv))
                kt = kh[:, :, None, cols]
                p, ds = p_ds(qh[..., rows, :] @ kt.transpose(-1, -2),
                             doh[..., rows, :] @ vh[:, :, None, cols].transpose(-1, -2), rows,
                             cols, lseh[..., rows], dsum[..., rows])
                dq[..., rows, :] += rnd(ds) @ kt
                seen_q[rows, cols] = True

    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return (dq, (dk * scale).transpose(1, 2), dv.transpose(1, 2)), seen_kv, seen_q, mask


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_grads(name, case, q, k, v, do):
    kw = _kw(case)
    attn = jax_ref.flash_attention_ref if name == "empty_rows" else JL._dense_attention
    _, vjp = jax.vjp(lambda *a: attn(*a, **kw), *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("plan", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_mirror_of_the_kernel_plan(name, plan):
    case = CASES[name]
    kw = _kw(case)
    bf16 = plan == "bf16"
    q, k, v, do = _inputs(case, bf16=bf16)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = ref.flash_attention_lse(tq, tk, tv, **kw)
    if bf16:        # the forward kernel writes its output in bf16
        out = out.bfloat16().float()
    got, seen_kv, seen_q, mask = _mirror_bwd(tq, tk, tv, out, lse, tdo, design=PLAN_DESIGN[plan],
                                             **kw)
    assert not (mask & ~seen_kv).any(), "the dK/dV tiles skip a valid pair"
    assert not (mask & ~seen_q).any(), "the dQ tiles skip a valid pair"
    wants = [[g.numpy() for g in ref.flash_attention_bwd(tq, tk, tv, out, tdo, **kw)],
             _jax_grads(name, case, q, k, v, do)]
    for want in wants:
        for g, w in zip(got, want):
            if bf16:
                assert _rel_l2(g.numpy(), w) <= BF16_REL_L2
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL, atol=F32_TOL)
    empty = ~mask.any(dim=-1)
    assert torch.all(got[0][:, empty] == 0), "a row with no valid key got a gradient"


@pytest.mark.parametrize("name", list(CASES))
def test_plain_lse_matches_jax_logsumexp(name):
    """``ref.flash_attention_lse``'s second output against
    ``jax.nn.logsumexp`` of JAX's masked scores (as ``flash_attention_ref``
    forms them): within 2e-5 where a row has a valid key, +inf where it has
    none (JAX's -inf there); the first output is ``flash_attention_ref``'s."""
    case = CASES[name]
    kw = _kw(case)
    b, sq, skv, h, kv, hd = case[:6]
    q, k, v, _ = _inputs(case)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = ref.flash_attention_lse(tq, tk, tv, **kw)
    assert torch.equal(out, ref.flash_attention_ref(tq, tk, tv, **kw))
    qf = (jnp.asarray(q) * hd ** -0.5).reshape(b, sq, kv, h // kv, hd)
    s = jnp.einsum("bqgrd,bkgd->bgrqk", qf, jnp.asarray(k))
    if kw["softcap"]:
        s = kw["softcap"] * jnp.tanh(s / kw["softcap"])
    mask = jnp.asarray(_mask(sq, skv, kw["causal"], kw["window"], kw["q_offset"]).numpy())
    want = np.asarray(jax.nn.logsumexp(s, axis=-1, where=mask[None, None, None])).reshape(b, h, sq)
    valid = np.isfinite(want)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy()[valid], want[valid], rtol=F32_TOL, atol=F32_TOL)
    assert np.all(np.isposinf(lse.numpy()[~valid]))
    assert (~valid).any() == (name == "empty_rows")


def _op_args():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(CASES["narrow_window_q_offset"]))
    kw = (True, 5, 0.0, 130)
    out, lse = ref.flash_attention_lse(q, k, v, causal=True, window=5, q_offset=130)
    return {"flash_attention_lse": (q, k, v, *kw),
            "flash_attention_backward": (q, k, v, out, lse, do, *kw)}


@pytest.mark.parametrize("name", ["flash_attention_lse", "flash_attention_backward"])
def test_new_operator_registration(name):
    """Schema and fake implementation by ``torch.library.opcheck``; on CPU
    tensors the operator is the plain version."""
    args = _op_args()[name]
    op = getattr(torch.ops.repro_torch, name).default
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    q, k, v, *rest = args
    causal, window, softcap, q_offset = rest[-4:]
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    want = (ref.flash_attention_lse(q, k, v, **kw) if name == "flash_attention_lse"
            else ref.flash_attention_bwd(q, k, v, rest[0], rest[2], **kw))
    for g, w in zip(op(*args), want):
        assert torch.equal(g, w)


def test_function_runs_both_operators():
    """Forward and backward of ``ops.flash_attention`` under autograd run
    ``flash_attention_lse`` once and ``flash_attention_backward`` once, each
    charged by its formula; without a gradient, ``flash_attention`` alone."""
    case = CASES["gqa"]
    kw = _kw(case)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    with cost.CostMode() as c:
        out = ops.flash_attention(q, k, v, **kw)
        torch.autograd.grad(out, (q, k, v), do)
    assert dict(c.kernel_calls) == {"flash_attention_lse": 1, "flash_attention_backward": 1}
    fwd = flash_attention.cost(q.shape, k.shape, 4, causal=True, window=6)
    bwd = flash_attention_bwd.cost(q.shape, k.shape, 4, causal=True, window=6)
    assert bwd["flops"] == 2.5 * fwd["flops"]
    with torch.no_grad(), cost.CostMode() as c:
        ops.flash_attention(q, k, v, **kw)
    assert dict(c.kernel_calls) == {"flash_attention": 1}
