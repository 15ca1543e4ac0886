"""The rounding plan of the wgmma flash kernel (``kernels/csrc/flash_attention.cu``),
rehearsed on the CPU.

``_tiled_emulation`` repeats the kernel's arithmetic in plain PyTorch: bf16
q and k with f32 sums, the online softmax in f32 over tiles of 128 keys in
the log2 domain (one multiply by hd**-0.5 * log2(e); with a softcap: scale,
cap * tanh(s / cap), times log2(e)), and P rounded to bf16 before p.v. It is
held to the port's plain version and to the JAX package's
``_dense_attention`` at the bf16 tolerance of the kernel tests, 2e-2, on the
same numpy inputs: the tolerances the card tests hold the kernel to suit its
rounding.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _dense_attention
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ref

TOL = 2e-2
BKV = 128
LOG2E = math.log2(math.e)


def _tiled_emulation(q, k, v, *, causal, window, softcap, q_offset=0):
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qf = q.float().reshape(b, sq, kvh, rep, hd)     # bf16 values, exact in f32
    kf, vf = k.float(), v.float()
    m = torch.full((b, kvh, rep, sq), -math.inf)
    l = torch.zeros((b, kvh, rep, sq))
    acc = torch.zeros((b, kvh, rep, sq, hd))
    qpos = torch.arange(sq)[:, None] + q_offset
    for kv0 in range(0, skv, BKV):
        kt, vt = kf[:, kv0:kv0 + BKV], vf[:, kv0:kv0 + BKV]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kt)
        if softcap:
            s = softcap * LOG2E * torch.tanh(s * (hd ** -0.5 / softcap))
        else:
            s = s * (hd ** -0.5 * LOG2E)
        kpos = torch.arange(kv0, kv0 + kt.shape[1])[None, :]
        mask = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.tensor(-math.inf))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(torch.bfloat16)


CASES = {
    # b, s, h, kv, hd, causal, window, softcap
    "gqa4-causal": (1, 512, 8, 2, 128, True, 0, 0.0),
    "softcap50": (1, 512, 8, 2, 128, True, 0, 50.0),
    "window100": (1, 512, 8, 2, 128, True, 100, 0.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tiled_bf16_plan_matches_both_references(name):
    b, s, h, kv, hd, causal, window, cap = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    q, k, v = (tensor_from_numpy(np.asarray(a)) for a in (jq, jk, jv))
    assert q.dtype == torch.bfloat16
    kw = dict(causal=causal, window=window, softcap=cap)

    got = _tiled_emulation(q, k, v, **kw).float()
    assert torch.isfinite(got).all() and got.shape == (b, s, h, hd)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, **kw).float(),
                               atol=TOL, rtol=TOL)
    want = np.asarray(_dense_attention(jq, jk, jv, **kw), np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
