"""Mamba2 (SSD, state-space duality) layer in PyTorch, mirroring
``repro/models/ssm.py``: the chunked-scan prefill form and the O(1)-state
decode form. [arXiv:2405.21060]

d_inner = expand * d_model, H = d_inner / head_dim SSM heads, shared
(n_groups = 1) B/C of size N = ssm_state; the input projection is split by
component (``in_x``, ``in_z``, ``in_bc``, ``in_dt``) as in JAX.

Prefill splits the sequence into chunks of length L: inside a chunk the
quadratic "attention" form, across chunks a recurrent state (B, H, N, hd),
carried by a Python loop over chunks where JAX runs ``lax.scan``. The casts
follow JAX: ``xs``, ``B``, ``C`` and ``dt`` (through softplus) in float32,
``y`` back in the input dtype before the gated rmsnorm, ``silu(z)`` taken in
float32 and then cast.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import init_normal, rmsnorm


def init_mamba(generator, cfg: ModelConfig, device=None) -> dict:
    """JAX's tree, dtypes and scales: projections N(0,1) * d**-0.5 and the
    conv weights N(0,1) * 0.2 in the config dtype; ``A_log``, ``D``,
    ``dt_bias`` and ``norm`` in float32."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = getattr(torch, cfg.dtype)
    s = d ** -0.5

    def normal(shape, scale):
        return init_normal(shape, generator, device, scale, dt)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_x": normal((d, di), s),
        "in_z": normal((d, di), s),
        "in_bc": normal((d, 2 * n), s),
        "in_dt": normal((d, h), s),
        "conv_x_w": normal((cfg.ssm_conv, di), 0.2),
        "conv_x_b": torch.zeros((di,), dtype=dt, device=device),
        "conv_bc_w": normal((cfg.ssm_conv, 2 * n), 0.2),
        "conv_bc_b": torch.zeros((2 * n,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": torch.zeros((di,), **f32),
        "out_proj": normal((di, d), di ** -0.5),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L). Returns (..., L, L) with out[i, j] = sum_{k=j+1..i} x_k
    for i >= j, -inf above the diagonal (masked after the difference, so
    ``exp`` gives 0 there, never NaN)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(L, device=x.device)
    mask = i[:, None] >= i[None, :]
    return diff.masked_fill(~mask, -math.inf)


def _causal_conv(x, w, b, s: int):
    """Depthwise causal conv. x: (B, S, C); w: (cw, C)."""
    cw = w.shape[0]
    padded = F.pad(x, (0, 0, cw - 1, 0))
    out = sum(padded[:, i:i + s, :] * w[i][None, None, :] for i in range(cw))
    return F.silu(out + b)


def _gated_out(y, z, params, cfg: ModelConfig, dtype):
    """y (f32) back in ``dtype``, gated by silu(z) taken in f32, rmsnorm, out_proj."""
    y = y.to(dtype)
    y = rmsnorm(y * F.silu(z.float()).to(dtype), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"]


CHUNK = 256


def check_length(s: int, chunk: int = CHUNK) -> None:
    """Raise ``ValueError`` unless a sequence of ``s`` tokens is at most
    ``chunk`` or a multiple of it (the JAX reference asserts the same)."""
    if s > chunk and s % chunk:
        raise ValueError(f"mamba_chunked: a sequence of {s} tokens is longer than the SSD "
                         f"chunk {chunk} and not a multiple of it; pad the prompt to a "
                         f"multiple of {chunk} or cut it to at most {chunk} tokens")


def mamba_chunked(x, params, cfg: ModelConfig, chunk: int = CHUNK,
                  initial_state=None, return_state: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model); with ``return_state`` also the
    final ssm state (B, H, N, hd) f32. Prefill form.

    S must be at most ``chunk`` or a multiple of it (``check_length``)."""
    b, s, _ = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    check_length(s, chunk)
    L = min(chunk, s)
    nc = s // L
    xr = x @ params["in_x"]
    z = x @ params["in_z"]
    bc = x @ params["in_bc"]
    dt_raw = x @ params["in_dt"]

    xs = _causal_conv(xr, params["conv_x_w"], params["conv_x_b"], s)
    bc = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"], s)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])                # (B,S,H)
    A = -torch.exp(params["A_log"])                                    # (H,)
    dA = dt * A                                                        # log-decay

    xs = xs.reshape(b, nc, L, h, hd).float()                           # (B,C,L,H,hd)
    Bc = bc[..., :n].reshape(b, nc, L, n).float()                      # (B,C,L,N)
    Cc = bc[..., n:].reshape(b, nc, L, n).float()
    dtc = dt.reshape(b, nc, L, h)                                      # (B,C,L,H)
    dAc = dA.reshape(b, nc, L, h)

    # intra-chunk (quadratic "attention" form)
    decay = torch.exp(_segsum(dAc.permute(0, 1, 3, 2)))               # (B,C,H,L,L)
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)                   # (B,C,L,L)
    wts = scores[:, :, None] * decay * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", wts, xs)

    # chunk summaries -> recurrent state pass
    dA_cum = torch.cumsum(dAc, dim=2)                                  # (B,C,L,H)
    dA_tot = dA_cum[:, :, -1, :]                                       # (B,C,H)
    w_in = torch.exp(dA_tot[:, :, None, :] - dA_cum) * dtc             # (B,C,L,H)
    chunk_states = torch.einsum("bclh,bcln,bclhp->bchnp", w_in, Bc, xs)  # (B,C,H,N,hd)

    state = (initial_state if initial_state is not None
             else torch.zeros((b, h, n, hd), dtype=torch.float32, device=x.device))
    hprevs = []
    for c in range(nc):
        hprevs.append(state)
        state = state * torch.exp(dA_tot[:, c])[:, :, None, None] + chunk_states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                                # state at chunk start

    # inter-chunk: y += C_l . exp(dA_cum_l) h_prev
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", Cc, torch.exp(dA_cum), hprevs)

    y = (y_intra + y_inter).reshape(b, s, h, hd)
    y = y + params["D"][None, None, :, None] * xs.reshape(b, s, h, hd)
    out = _gated_out(y.reshape(b, s, di), z, params, cfg, x.dtype)
    if return_state:
        return out, state
    return out


def mamba_decode_step(x, state, params, cfg: ModelConfig):
    """Single-token decode. x: (B, 1, d_model); state = {"conv_x": (B, cw-1,
    di), "conv_bc": (B, cw-1, 2N), "ssm": (B, H, N, hd)}. Returns (y (B, 1,
    d_model), new state); the state passed in is not written."""
    b = x.shape[0]
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x0 = x[:, 0, :]
    xr = x0 @ params["in_x"]
    z = x0 @ params["in_z"]
    bc = x0 @ params["in_bc"]
    dt_raw = x0 @ params["in_dt"]

    hist_x = torch.cat([state["conv_x"], xr[:, None, :]], dim=1)
    hist_bc = torch.cat([state["conv_bc"], bc[:, None, :]], dim=1)
    conv_x = F.silu((hist_x * params["conv_x_w"][None]).sum(dim=1) + params["conv_x_b"])
    conv_bc = F.silu((hist_bc * params["conv_bc_w"][None]).sum(dim=1) + params["conv_bc_b"])

    xs = conv_x.reshape(b, h, hd).float()
    Bv = conv_bc[:, :n].float()                                        # (B,N)
    Cv = conv_bc[:, n:].float()

    dt = F.softplus(dt_raw.float() + params["dt_bias"])                # (B,H)
    dA = torch.exp(dt * -torch.exp(params["A_log"]))                   # (B,H)

    hs = state["ssm"] * dA[:, :, None, None] + torch.einsum("bh,bn,bhp->bhnp", dt, Bv, xs)
    y = torch.einsum("bn,bhnp->bhp", Cv, hs)
    y = y + params["D"][None, :, None] * xs
    out = _gated_out(y.reshape(b, 1, di), z[:, None, :], params, cfg, x.dtype)
    return out, {"conv_x": hist_x[:, 1:, :], "conv_bc": hist_bc[:, 1:, :], "ssm": hs}


def init_mamba_state(batch: int, cfg: ModelConfig, dtype=torch.float32, device=None) -> dict:
    """Zero decode state: conv tails in the config dtype, ssm state in ``dtype``."""
    dt = getattr(torch, cfg.dtype)
    return {
        "conv_x": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dt, device=device),
        "conv_bc": torch.zeros((batch, cfg.ssm_conv - 1, 2 * cfg.ssm_state), dtype=dt,
                               device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=dtype, device=device),
    }
