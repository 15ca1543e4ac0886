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
float32 and then cast. Under a profiler the layer is the range
``ssm.mixer`` and its core the range ``ssm.scan``.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import group_size, psum
from repro_torch.distributed.sharding import (P, PartitionSpec, cut_axes, dp_axes, dp_size,
                                              placements)
from repro_torch.launch.mesh import mesh_shape
from .layers import init_normal, profiled, rmsnorm


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


def _gated_norm(y, z, norm, *, eps: float, dtype, groups=()):
    """y (f32) back in ``dtype``, gated by silu(z) taken in f32, then the
    rmsnorm over ``d_inner``. With ``groups`` (a rank's channels of
    ``d_inner`` under ``local_map``) the sum of squares is summed over the
    ranks of the groups (``psum``, whose gradient is its own transpose)."""
    g = y.to(dtype) * F.silu(z.float()).to(dtype)
    if not groups:
        return rmsnorm(g, norm, eps)
    gf = g.float()
    ss = psum(gf.square().sum(dim=-1, keepdim=True), groups)
    gf = gf * torch.rsqrt(ss / (gf.shape[-1] * group_size(groups)) + eps)
    return (gf * (1.0 + norm.float())).to(dtype)


CHUNK = 256


def check_length(s: int, chunk: int = CHUNK) -> None:
    """Raise ``ValueError`` unless a sequence of ``s`` tokens is at most
    ``chunk`` or a multiple of it (the JAX reference asserts the same)."""
    if s > chunk and s % chunk:
        raise ValueError(f"mamba_chunked: a sequence of {s} tokens is longer than the SSD "
                         f"chunk {chunk} and not a multiple of it; pad the prompt to a "
                         f"multiple of {chunk} or cut it to at most {chunk} tokens")


# the Mamba2 layer's parameters in the order the mixers take them: the
# projections, the norm and out_proj, then those the SSD core reads
MIXER_PARAMS = ("in_x", "in_z", "in_bc", "in_dt", "norm", "out_proj",
                "conv_x_w", "conv_x_b", "conv_bc_w", "conv_bc_b", "A_log", "D", "dt_bias")


def _scan(xr, bc, dt_raw, conv_x_w, conv_x_b, conv_bc_w, conv_bc_b, A_log, D, dt_bias, *,
          n: int, hd: int, chunk: int, initial_state=None):
    """The SSD core over the heads its inputs hold: the causal convs, the
    chunked scan and the D skip. xr (B, S, h*hd), bc (B, S, 2N), dt_raw
    (B, S, h), and the parameters' slices of those h heads. Returns y (B,
    S, h*hd) f32 and the final state (B, h, N, hd) f32. Heads do not meet
    here, so a rank's heads give that rank's slice of the whole."""
    b, s, _ = xr.shape
    h = dt_raw.shape[-1]
    L = min(chunk, s)
    nc = s // L
    xs = _causal_conv(xr, conv_x_w, conv_x_b, s)
    bc = _causal_conv(bc, conv_bc_w, conv_bc_b, s)

    dt = F.softplus(dt_raw.float() + dt_bias)                          # (B,S,H)
    A = -torch.exp(A_log)                                              # (H,)
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
             else torch.zeros((b, h, n, hd), dtype=torch.float32, device=xr.device))
    hprevs = []
    for c in range(nc):
        hprevs.append(state)
        state = state * torch.exp(dA_tot[:, c])[:, :, None, None] + chunk_states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                                # state at chunk start

    # inter-chunk: y += C_l . exp(dA_cum_l) h_prev
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", Cc, torch.exp(dA_cum), hprevs)

    y = (y_intra + y_inter).reshape(b, s, h, hd)
    y = y + D[None, None, :, None] * xs.reshape(b, s, h, hd)
    return y.reshape(b, s, h * hd), state


def mesh_layout(mesh, batch: int | None, cfg: ModelConfig) -> tuple:
    """(dp, tp) of the Mamba2 layer on ``mesh``, as JAX's rules cut it: the
    batch over the data-parallel axes where they divide it (``batch`` None:
    every row on every rank), the heads (and with them the ``d_inner``
    channels) over ``model`` where it divides them, else every head on
    every rank. B and C stay whole (``in_bc`` is ``P(F, None)``)."""
    dp = (dp_axes(mesh) if batch is not None and batch % dp_size(mesh) == 0
          and dp_size(mesh) > 1 else None)
    tp = "model" if cfg.ssm_heads % mesh_shape(mesh)["model"] == 0 else None
    return dp, tp


def _grads(spec: PartitionSpec, mesh, summed) -> list:
    """The gradient placements of an input that a ``local_map`` core reads
    with ``spec``'s placements: ``Partial`` (a sum) on the mesh axes named
    in ``summed``, where each rank's gradient is only its share (its rows of
    a replicated parameter; its heads' part of B, C and their conv)."""
    names = list(mesh_shape(mesh))
    cut = {names.index(a) for a in summed}
    return [Partial() if i in cut else p for i, p in enumerate(placements(spec, mesh))]


def _on_mesh(mixer, mesh, dp, tp, n_state: int, grad: bool):
    """``mixer(x, *MIXER_PARAMS[:6], *state, *MIXER_PARAMS[6:]) -> (out,
    *state)`` under ``local_map``, the whole Mamba2 layer on a rank's rows
    (over ``dp``) and heads and ``d_inner`` channels (over ``tp``): the
    projections on the weights' column slices (gathered over the data axes,
    as FSDP gathers them), B and C (``in_bc`` and their conv) whole on
    every rank of ``model``, and ``out_proj``'s partial sums returned as a
    sum over ``model`` (``Partial``), reduced where the output is used, as
    GSPMD keeps JAX's layer sharded. ``n_state`` state inputs (the decode
    step's conv_x, conv_bc, ssm) come after the weights, as many state
    outputs after ``out`` (the prefill's final ssm state when it is 0)."""
    seq = (None,) if n_state == 0 else ()
    states = (P(dp, None, tp), P(dp, None, None), P(dp, tp, None, None))
    specs = (P(dp, *seq, None), P(None, tp), P(None, tp), P(), P(None, tp), P(tp),
             P(tp, None), *states[:n_state], P(None, tp), P(tp), P(), P(), P(tp), P(tp),
             P(tp))
    rows, heads = tuple(dp or ()), (tp,) if tp else ()
    summed = (heads, rows, rows, rows + heads, rows, rows, rows, *[()] * n_state, rows, rows,
              rows + heads, rows + heads, rows, rows, rows)
    out = _grads(P(dp, *seq, None), mesh, heads)          # partial sums over model
    outs = (out, *(placements(sp, mesh) for sp in (states if n_state else states[2:])))
    grads = {"in_grad_placements": tuple(_grads(sp, mesh, sm) for sp, sm in zip(specs, summed))}
    return local_map(mixer, out_placements=outs,
                     in_placements=tuple(placements(sp, mesh) for sp in specs),
                     device_mesh=mesh, redistribute_inputs=True, **(grads if grad else {}))


def _project_bc(x, in_bc, groups, part):
    """``x @ in_bc``, B and C, which every head reads. With ``part`` (this
    rank's index and the count of ``groups``' ranks, which ``d_model``
    divides) each rank multiplies its slice of ``d_model`` and the partial
    products are summed (``psum``), so the ranks of ``model`` share the
    product instead of each computing all of it."""
    if not part:
        return x @ in_bc
    i, n = part
    d = x.shape[-1] // n
    return psum(x[..., i * d:(i + 1) * d] @ in_bc[i * d:(i + 1) * d], groups)


def _model_groups(mesh, tp, d_model: int) -> dict:
    """The mixer's ``groups`` (the norm's sum and B/C's product over
    ``model`` when it cuts the heads) and ``part`` (this rank's slice of
    ``d_model`` for B/C, where ``model`` divides it)."""
    n = mesh_shape(mesh)[tp] if tp else 1
    if n == 1:                 # every head on this rank: the unsharded mixer
        return {"groups": []}
    part = (mesh.get_local_rank(tp), n) if d_model % n == 0 else None
    return {"groups": [mesh.get_group(tp)], "part": part}


def _mixer(x, in_x, in_z, in_bc, in_dt, norm, out_proj, *w, n, hd, chunk, eps, groups=(),
           part=None, initial_state=None):
    """The Mamba2 layer over the heads its weights hold: projections,
    ``_scan``, the gate and the norm (``_gated_norm`` over ``groups``),
    ``out_proj``. Returns (out, final state)."""
    bc = _project_bc(x, in_bc, groups, part)
    xr, dt_raw = x @ in_x, x @ in_dt
    with profiled("ssm.scan"):
        y, state = _scan(xr, bc, dt_raw, *w, n=n, hd=hd, chunk=chunk,
                         initial_state=initial_state)
    return _gated_norm(y, x @ in_z, norm, eps=eps, dtype=x.dtype, groups=groups) @ out_proj, state


def mamba_chunked(x, params, cfg: ModelConfig, chunk: int = CHUNK,
                  initial_state=None, return_state: bool = False, mesh=None):
    """x: (B, S, d_model) -> (B, S, d_model); with ``return_state`` also the
    final ssm state (B, H, N, hd) f32. Prefill form.

    S must be at most ``chunk`` or a multiple of it (``check_length``).

    With a ``mesh`` and a DTensor ``x`` the layer runs under ``local_map``
    on each rank's rows and heads (``mesh_layout``, ``_on_mesh``); the
    output comes back as partial sums over ``model`` and the state cut by
    rows and heads."""
    b, s, _ = x.shape
    check_length(s, chunk)
    args = (x, *(params[k] for k in MIXER_PARAMS))
    mixer = partial(_mixer, n=cfg.ssm_state, hd=cfg.ssm_head_dim, chunk=chunk, eps=cfg.norm_eps)
    with profiled("ssm.mixer"):
        if mesh is not None and isinstance(x, DTensor):
            assert initial_state is None, "the mesh route starts from a zero state"
            dp, tp = mesh_layout(mesh, b, cfg)
            mixer = partial(mixer, **_model_groups(mesh, tp, x.shape[-1]))
            out, state = _on_mesh(mixer, mesh, dp, tp, 0, True)(*args)
        else:
            out, state = mixer(*args, initial_state=initial_state)
    return (out, state) if return_state else out


def _step(xr, bc, dt_raw, conv_x, conv_bc, ssm, conv_x_w, conv_x_b, conv_bc_w, conv_bc_b,
          A_log, D, dt_bias, *, n: int, hd: int):
    """One token of the SSD core over the heads its inputs hold: xr (B,
    h*hd), bc (B, 2N), dt_raw (B, h), the state's conv tails and ssm state
    of those heads. Returns y (B, h*hd) f32 and the new conv_x, conv_bc
    and ssm."""
    b, h = dt_raw.shape
    hist_x = torch.cat([conv_x, xr[:, None, :]], dim=1)
    hist_bc = torch.cat([conv_bc, bc[:, None, :]], dim=1)
    cx = F.silu((hist_x * conv_x_w[None]).sum(dim=1) + conv_x_b)
    cbc = F.silu((hist_bc * conv_bc_w[None]).sum(dim=1) + conv_bc_b)

    xs = cx.reshape(b, h, hd).float()
    Bv = cbc[:, :n].float()                                            # (B,N)
    Cv = cbc[:, n:].float()

    dt = F.softplus(dt_raw.float() + dt_bias)                          # (B,H)
    dA = torch.exp(dt * -torch.exp(A_log))                             # (B,H)

    hs = ssm * dA[:, :, None, None] + torch.einsum("bh,bn,bhp->bhnp", dt, Bv, xs)
    y = torch.einsum("bn,bhnp->bhp", Cv, hs)
    y = y + D[None, :, None] * xs
    return y.reshape(b, h * hd), hist_x[:, 1:, :], hist_bc[:, 1:, :], hs


def _step_mixer(x0, in_x, in_z, in_bc, in_dt, norm, out_proj, *sw, n, hd, eps, groups=(),
                part=None):
    """One token of the Mamba2 layer over the heads its weights and state
    hold, ``_mixer``'s decode form: x0 (B, d_model). Returns (out (B,
    d_model), new conv_x, conv_bc, ssm)."""
    bc = _project_bc(x0, in_bc, groups, part)
    y, *new = _step(x0 @ in_x, bc, x0 @ in_dt, *sw, n=n, hd=hd)
    out = _gated_norm(y, x0 @ in_z, norm, eps=eps, dtype=x0.dtype, groups=groups) @ out_proj
    return (out, *new)


def mamba_decode_step(x, state, params, cfg: ModelConfig):
    """Single-token decode. x: (B, 1, d_model); state = {"conv_x": (B, cw-1,
    di), "conv_bc": (B, cw-1, 2N), "ssm": (B, H, N, hd)}. Returns (y (B, 1,
    d_model), new state); the state passed in is not written.

    With a DTensor ``x`` and a state of DTensors the layer runs under
    ``local_map`` (``_on_mesh``) on the rows and heads the ``ssm`` leaf's
    placements cut; the output comes back as partial sums over ``model``,
    the new state in the placements of the state passed in."""
    keys = ("conv_x", "conv_bc", "ssm")
    w = [params[k] for k in MIXER_PARAMS]
    args = (x[:, 0, :], *w[:6], *(state[k] for k in keys), *w[6:])
    mixer = partial(_step_mixer, n=cfg.ssm_state, hd=cfg.ssm_head_dim, eps=cfg.norm_eps)
    ssm = state["ssm"]
    if isinstance(x, DTensor) and isinstance(ssm, DTensor):
        mesh = ssm.device_mesh
        dp, tp = cut_axes(ssm, 0), (cut_axes(ssm, 1) or (None,))[0]
        mixer = partial(mixer, **_model_groups(mesh, tp, x.shape[-1]))
        out, *new = _on_mesh(mixer, mesh, dp, tp, 3, False)(*args)
        new = {k: v.redistribute(mesh, state[k].placements) for k, v in zip(keys, new)}
        return out[:, None, :], new
    out, *new = mixer(*args)
    return out[:, None, :], dict(zip(keys, new))


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
