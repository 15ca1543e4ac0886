"""The port's MoE and Mamba2 layers against the JAX package, one function at a
time, on the same numpy inputs and weights (reduced configs, float32); and the
parameter layout and converted dtypes of the MoE, Mamba2 and hybrid families."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

FAMILIES = ["olmoe-1b-7b", "granite-moe-1b-a400m", "mamba2-780m", "jamba-v0.1-52b"]
TOL = 2e-5


def _t(x):
    return tensor_from_numpy(np.asarray(x))


def _close(out, want, tol=TOL):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfgs(arch, **kw):
    return jax_reduced(jax_get_config(arch), **kw), reduced(get_config(arch), **kw)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,factor", [(4, 1.25), (47, 1.25), (512, 1.25), (48, 16.0),
                                           (4096, 1.25)])
def test_capacity_matches_jax(tokens, factor):
    jcfg, cfg = _cfgs("olmoe-1b-7b")
    jcfg, cfg = (dataclasses.replace(c, moe_experts=64, moe_topk=8) for c in (jcfg, cfg))
    assert M._capacity(tokens, cfg, factor) == JM._capacity(tokens, jcfg, factor)


def _moe_inputs(cfg, skew: bool):
    """x (2, 64, d) and MoE weights from a seed. With ``skew`` every token's
    router logit for expert 0 is large (x has mean 1, the router's column 0
    mean 0.3), so expert 0 takes all 128 tokens and overflows its capacity."""
    rng = np.random.default_rng(11 if skew else 10)
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    x = _normal(rng, 2, 64, d) + (1.0 if skew else 0.0)
    router = _normal(rng, d, e, scale=d ** -0.5)
    if skew:
        router[:, 0] += 0.3
    p = {"router": router, "w_gate": _normal(rng, e, d, f, scale=d ** -0.5),
         "w_up": _normal(rng, e, d, f, scale=d ** -0.5),
         "w_down": _normal(rng, e, f, d, scale=f ** -0.5)}
    return x, p


def _jax_routing(x, p, jcfg, cap):
    """The routing lines of JAX ``moe_local`` (moe.py:51-54, 78-83): expert
    ids (T, k), whether each assignment is kept, and the top-k probabilities
    with the next one down."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ jnp.asarray(p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.moe_topk)
    e_flat = idx.reshape(-1)
    oh = jax.nn.one_hot(e_flat, jcfg.moe_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1, e_flat[:, None], axis=1)[:, 0]
    ranked = -np.sort(-np.asarray(probs), axis=-1)[:, :jcfg.moe_topk + 1]
    return np.asarray(idx), np.asarray(pos < cap), ranked


@pytest.mark.parametrize("factor,skew", [(16.0, False), (1.25, True)],
                         ids=["drop-free", "published-1.25-drops"])
def test_moe_local_matches_jax(factor, skew):
    """Outputs and aux losses within 2e-5, the routing (expert ids and the
    kept assignments) exactly JAX's. At the published 1.25 with a skewed
    router, tokens drop."""
    jcfg, cfg = _cfgs("olmoe-1b-7b", moe_capacity_factor=factor)
    x, p = _moe_inputs(cfg, skew)
    out, aux = M.moe_local(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    want, jaux = JM.moe_local(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jcfg)
    _close(out, want)
    for k in ("lb", "z"):
        _close(aux[k], jaux[k])

    t = x.shape[0] * x.shape[1]
    cap = M._capacity(t, cfg)
    _, idx, _ = M.route(_t(x).reshape(t, -1), {k: _t(v) for k, v in p.items()}, cfg)
    keep, dest = M.dispatch(idx, cfg.moe_experts, cap)
    jidx, jkeep, ranked = _jax_routing(x, p, jcfg, cap)
    # no two of a token's top k+1 probabilities tie to f32 rounding here
    assert (np.diff(ranked, axis=-1) < 0).all()
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert (dest[~keep] == cfg.moe_experts * cap).all()
    kept = dest[keep]
    assert len(torch.unique(kept)) == len(kept), "kept slots must be unique"
    if skew:
        assert (~keep).sum() > 0, "the published factor must drop tokens here"
    else:
        assert keep.all()


def test_moe_ffn_refuses_a_mesh():
    """``moe_ffn`` takes a mesh since the distribution slice (its routes over
    a mesh are held to JAX's in tests/test_torch_distributed.py): it refuses
    an object that is no mesh, and a mesh without the EP axis takes the
    local math, as JAX's."""
    from repro_torch.launch.mesh import MeshShape

    _, cfg = _cfgs("olmoe-1b-7b")
    x, p = _moe_inputs(cfg, False)
    tp = {k: _t(v) for k, v in p.items()}
    with pytest.raises(TypeError, match="mesh"):
        M.moe_ffn(_t(x), tp, cfg, mesh=object())
    y, aux = M.moe_ffn(_t(x), tp, cfg, mesh=MeshShape({"model": 1}))
    want, want_aux = M.moe_local(_t(x), tp, cfg)
    assert torch.equal(y, want) and torch.equal(aux["lb"], want_aux["lb"])


# The dispatch on a stable sort, held to the one-hot cumsum it replaced
# (JAX's formula) and to the gathers autograd differentiates through indexing.

def _dispatch_by_cumsum(idx, n_experts, cap):
    """The slots as JAX computes them: a cumsum down the (T*k, E) one-hot."""
    e_flat = idx.reshape(-1)
    pos = (torch.cumsum(F.one_hot(e_flat, n_experts), dim=0) - 1).gather(1, e_flat[:, None])[:, 0]
    keep = pos < cap
    return keep, torch.where(keep, e_flat * cap + pos, n_experts * cap)


def _expert_ids(case, n_experts, n_assign, k=8, seed=0):
    """(n_assign // k, k) expert ids. "zipf": k distinct experts a token,
    drawn with Zipf(1.2) weights, so the first experts overflow; "one": every
    assignment to expert 0; "ties": every token picks the same k experts in
    the same order, so each expert's assignments tie in all but token order."""
    g = torch.Generator().manual_seed(seed)
    t = n_assign // k
    if case == "one":
        return torch.zeros(t, k, dtype=torch.long)
    if case == "ties":
        return torch.randperm(n_experts, generator=g)[:k].expand(t, k).clone()
    zipf = 1.0 / torch.arange(1, n_experts + 1, dtype=torch.float64) ** 1.2
    ids = torch.multinomial(zipf.expand(t, n_experts), k, generator=g)
    return torch.randperm(n_experts, generator=g)[ids]


@pytest.mark.parametrize("case,factor", [("zipf", 1.25), ("zipf", 0.5), ("zipf", 16.0),
                                         ("one", 1.25), ("ties", 1.25)])
@pytest.mark.parametrize("n_assign", [256, 16_384])
@pytest.mark.parametrize("n_experts", [32, 64])
def test_dispatch_matches_one_hot_cumsum(n_experts, n_assign, case, factor):
    """``dispatch`` returns the one-hot cumsum's (keep, dest) exactly, drops
    (factor 0.5 and 1.25) and no drops (16) alike, and its kept slots are
    unique and token-major within each expert."""
    idx = _expert_ids(case, n_experts, n_assign)
    cap = max(8, -(-int(n_assign / n_experts * factor) // 8) * 8)
    keep, dest = M.dispatch(idx, n_experts, cap)
    want_keep, want_dest = _dispatch_by_cumsum(idx, n_experts, cap)
    assert torch.equal(keep, want_keep) and torch.equal(dest, want_dest)
    assert bool((~keep).any()) == (case != "zipf" or factor < 16), "drops as the case intends"
    kept = dest[keep]
    assert len(torch.unique(kept)) == len(kept)
    src = M.slot_sources(dest, n_experts * cap)
    filled = src < n_assign
    assert torch.equal(dest[src[filled]], torch.arange(n_experts * cap)[filled])
    slot = torch.arange(n_experts * cap)
    assert (src[filled][1:] > src[filled][:-1])[(slot[filled] % cap)[1:] > 0].all()


def _moe_local_by_index(x, p, cfg):
    """``moe_local``'s single-rank math with the gathers it had before
    ``_GatherRows``: autograd differentiates ``x_pad[buf]`` and the masked
    ``y[dest]`` itself, with an accumulating ``index_put``."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    t = b * s
    xf = x.reshape(t, d)
    w, idx, aux = M.route(xf, p, cfg)
    cap = M._capacity(t, cfg)
    keep, dest = M.dispatch(idx, e, cap)
    token = torch.arange(t * k) // k
    buf = torch.full((e * cap + 1,), t, dtype=torch.long).scatter(0, dest, token)[:e * cap]
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xg = x_pad[buf].reshape(e, cap, d)
    h = F.silu(torch.bmm(xg, p["w_gate"])) * torch.bmm(xg, p["w_up"])
    y = torch.bmm(h, p["w_down"]).reshape(e * cap, d)
    out_tk = y[torch.where(keep, dest, 0)]
    out_tk = torch.where(keep[:, None], out_tk, out_tk.new_zeros(()))
    return (out_tk.reshape(t, k, d) * w[..., None]).sum(dim=1).reshape(b, s, d), aux


def _moe_grads(fn, x, p, cfg, seed=3):
    """Gradients in x and the four MoE weights of <fn's output, a fixed
    random cotangent> + lb + z."""
    leaves = {"x": _t(x).requires_grad_(), **{k: _t(v).requires_grad_() for k, v in p.items()}}
    out, aux = fn(leaves["x"], {k: v for k, v in leaves.items() if k != "x"}, cfg)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    ((out * cot).sum() + aux["lb"] + aux["z"]).backward()
    return {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("experts", [(4, 2), (32, 8)], ids=["E4-k2", "E32-k8"])
@pytest.mark.parametrize("factor,skew", [(16.0, False), (1.25, True)],
                         ids=["drop-free", "published-1.25-drops"])
def test_moe_local_grads_match_index_gathers(factor, skew, experts):
    """``moe_local``'s gradients in x, the router and the three expert
    weights equal autograd's through the indexing gathers, within the
    parity tests' 2e-5."""
    _, cfg = _cfgs("olmoe-1b-7b", moe_capacity_factor=factor)
    cfg = dataclasses.replace(cfg, moe_experts=experts[0], moe_topk=experts[1])
    x, p = _moe_inputs(cfg, skew)
    got = _moe_grads(M.moe_local, x, p, cfg)
    want = _moe_grads(_moe_local_by_index, x, p, cfg)
    for k in want:
        assert got[k].abs().max() > 0, k
        _close(got[k], want[k].numpy())


@pytest.mark.parametrize("use", ["dispatch", "combine"])
def test_gather_rows_gradcheck(use):
    """float64 ``gradcheck`` of ``_GatherRows`` as ``moe_local`` uses it, on
    6 tokens top-2 over 3 experts of capacity 3 (four assignments drop, one
    slot stays empty): token rows into the buffer (the backward sums each
    token's k slots) and buffer rows back to the assignments."""
    idx = torch.tensor([[0, 1], [0, 1], [1, 0], [0, 1], [1, 2], [0, 2]])
    e, k, cap = 3, 2, 3
    keep, dest = M.dispatch(idx, e, cap)
    src = M.slot_sources(dest, e * cap)
    assert (~keep).sum() == 4 and (src == idx.numel()).sum() == 1
    g = torch.Generator().manual_seed(0)
    if use == "dispatch":
        leaf, index, inverse, group = torch.randn(6, 3, generator=g), src // k, dest, k
    else:
        leaf, index, inverse, group = torch.randn(e * cap, 3, generator=g), dest, src, 1
    leaf = leaf.double().requires_grad_()
    assert torch.autograd.gradcheck(lambda v: M._GatherRows.apply(v, index, inverse, group),
                                    (leaf,))


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched under it, with whether an index_put
    accumulates."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in ("index_put", "index_put_", "_index_put_impl_"):
            if kwargs.get("accumulate", len(args) > 3 and args[3]):
                name += "(accumulate)"
        self.ops.append(name)
        return func(*args, **kwargs)


ACCUMULATING = {"index_put(accumulate)", "index_put_(accumulate)",
                "_index_put_impl_(accumulate)", "index_add", "index_add_", "scatter_add",
                "scatter_add_", "scatter_reduce", "scatter_reduce_"}


def test_moe_dispatch_runs_no_accumulating_or_syncing_op():
    """Under an op log on the CPU: ``moe_local``'s backward runs no
    accumulating scatter (the indexing gathers' backward does, which shows
    the log sees it); ``dispatch`` runs nothing that syncs the host on the
    card; the no-grad forward at olmoe's decode shape (T 32, E 64, k 8)
    dispatches no more ops than the one-hot cumsum's 67."""
    _, cfg = _cfgs("olmoe-1b-7b", moe_capacity_factor=1.25)
    x, p = _moe_inputs(cfg, True)
    for fn, accumulates in ((M.moe_local, False), (_moe_local_by_index, True)):
        leaves = {k: _t(v).requires_grad_() for k, v in p.items()}
        out, aux = fn(_t(x).requires_grad_(), leaves, cfg)
        with _OpLog() as log:
            (out.square().sum() + aux["lb"]).backward()
        assert "bmm" in log.ops
        assert bool(ACCUMULATING & set(log.ops)) == accumulates, sorted(set(log.ops))

    with _OpLog() as log:
        M.dispatch(_expert_ids("zipf", 64, 16_384), 64, 320)
    assert not {"_local_scalar_dense", "item", "nonzero", "bincount",
                "masked_select"} & set(log.ops), log.ops

    cfg = dataclasses.replace(cfg, moe_experts=64, moe_topk=8)
    pd = {k: _t(v) for k, v in _moe_inputs(cfg, False)[1].items()}
    xd = torch.randn(32, 1, cfg.d_model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), _OpLog() as log:
        M.moe_local(xd, pd, cfg)
    assert len(log.ops) <= 67, len(log.ops)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def _mamba_params(arch="mamba2-780m", seed=0):
    jcfg, cfg = _cfgs(arch)
    jp = JS.init_mamba(jax.random.PRNGKey(seed), jcfg)
    # non-trivial D, dt_bias and norm (the init has them at 1, 0 and 0)
    rng = np.random.default_rng(seed)
    jp = {**jp, "D": jnp.asarray(_normal(rng, jcfg.ssm_heads)),
          "dt_bias": jnp.asarray(_normal(rng, jcfg.ssm_heads, scale=0.5)),
          "norm": jnp.asarray(_normal(rng, jcfg.d_inner, scale=0.1)),
          "conv_x_b": jnp.asarray(_normal(rng, jcfg.d_inner, scale=0.1))}
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp))


def test_segsum_matches_jax():
    x = _normal(np.random.default_rng(1), 2, 3, 9)
    out = S._segsum(_t(x))
    want = np.asarray(JS._segsum(jnp.asarray(x)))
    assert torch.isinf(out).sum() == np.isinf(want).sum() == 2 * 3 * 36
    fin = np.isfinite(want)
    _close(out[torch.from_numpy(fin)], want[fin])
    assert not torch.isnan(torch.exp(out)).any()
    assert (torch.exp(out)[torch.from_numpy(~fin)] == 0).all()


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(2)
    x, w, b = _normal(rng, 2, 7, 12), _normal(rng, 4, 12), _normal(rng, 12)
    _close(S._causal_conv(_t(x), _t(w), _t(b), 7),
           JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 7))


@pytest.mark.parametrize("s,chunk,with_state", [(24, 8, True), (24, 256, False), (5, 256, True)],
                         ids=["3-chunks-initial-state", "one-chunk", "short"])
def test_mamba_chunked_matches_jax(s, chunk, with_state):
    jcfg, jp, cfg, tp = _mamba_params()
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, s, cfg.d_model)
    h0 = (_normal(rng, 2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, scale=0.3)
          if with_state else None)
    out, st = S.mamba_chunked(_t(x), tp, cfg, chunk=chunk, return_state=True,
                              initial_state=None if h0 is None else _t(h0))
    want, jst = JS.mamba_chunked(jnp.asarray(x), jp, jcfg, chunk=chunk, return_state=True,
                                 initial_state=None if h0 is None else jnp.asarray(h0))
    _close(out, want)
    _close(st, jst)
    assert st.dtype == torch.float32


def test_mamba_decode_step_matches_jax():
    jcfg, jp, cfg, tp = _mamba_params()
    rng = np.random.default_rng(4)
    x = _normal(rng, 3, 1, cfg.d_model)
    state = {"conv_x": _normal(rng, 3, cfg.ssm_conv - 1, cfg.d_inner),
             "conv_bc": _normal(rng, 3, cfg.ssm_conv - 1, 2 * cfg.ssm_state),
             "ssm": _normal(rng, 3, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)}
    tstate = {k: _t(v) for k, v in state.items()}
    out, new = S.mamba_decode_step(_t(x), tstate, tp, cfg)
    want, jnew = JS.mamba_decode_step(jnp.asarray(x), {k: jnp.asarray(v)
                                                       for k, v in state.items()}, jp, jcfg)
    _close(out, want)
    for k in state:
        _close(new[k], jnew[k])
        _close(tstate[k], state[k], 0.0)           # the state passed in is not written


def test_mamba_chunk_invariance():
    """The SSD chunked scan does not depend on the chunk size (as
    tests/test_models.py), and matches JAX at each."""
    jcfg, jp, cfg, tp = _mamba_params()
    x = _normal(np.random.default_rng(5), 2, 64, cfg.d_model)
    y16 = S.mamba_chunked(_t(x), tp, cfg, chunk=16)
    y64 = S.mamba_chunked(_t(x), tp, cfg, chunk=64)
    _close(y16, y64.numpy(), 2e-4)
    _close(y16, JS.mamba_chunked(jnp.asarray(x), jp, jcfg, chunk=16))


def test_mamba_chunked_rejects_a_ragged_long_sequence():
    """Longer than a chunk and not a multiple of it: JAX asserts, the port
    raises with the remedy in the message."""
    _, _, cfg, tp = _mamba_params()
    x = torch.zeros((1, 300, cfg.d_model))
    with pytest.raises(ValueError, match="not a multiple of it"):
        S.mamba_chunked(x, tp, cfg)


def test_init_mamba_state_matches_jax():
    jcfg, cfg = _cfgs("mamba2-780m", dtype="bfloat16")
    want = JS.init_mamba_state(3, jcfg)
    got = S.init_mamba_state(3, cfg)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
        assert not got[k].any()


# ---------------------------------------------------------------------------
# parameters of the new families: layout, dtypes, scales; converted dtypes
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


F32_LEAVES = ("norm", "router", "A_log", "D", "dt_bias", "q_norm", "k_norm")


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_init_of_new_families_has_jax_layout_dtypes_and_scales(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    jleaves = dict(_leaves(jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))))
    tleaves = dict(_leaves(T.init_params(cfg, torch.Generator().manual_seed(0))))
    assert tleaves.keys() == jleaves.keys()
    for k, want in jleaves.items():
        got = tleaves[k]
        assert tuple(got.shape) == want.shape, k
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), k
        name = k.rsplit(".", 1)[-1]
        if name in ("router", "w_up", "in_x", "in_bc", "embed"):     # N(0,1) * d**-0.5
            assert abs(got.float().std().item() * cfg.d_model ** 0.5 - 1) < 0.1, k
        if name == "w_down" and ".moe." in k:                          # * d_ff**-0.5
            assert abs(got.float().std().item() * cfg.moe_d_ff ** 0.5 - 1) < 0.1, k
        if name in ("norm", "dt_bias", "conv_x_b", "conv_bc_b") or name.endswith("_norm"):
            assert torch.all(got == 0), k
        if name == "D":
            assert torch.all(got == 1), k
        if name == "A_log":
            _close(got, np.broadcast_to(np.log(np.linspace(1.0, 16.0, cfg.ssm_heads)),
                                        got.shape), 1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_converted_leaves_keep_their_dtypes(arch):
    """A bf16 JAX model crosses with the router, A_log, D, dt_bias and the
    norm scales in float32 and every other leaf in bfloat16, values equal."""
    jcfg, _ = _cfgs(arch, dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = params_from_jax(jparams)
    jleaves, tleaves = dict(_leaves(jparams)), dict(_leaves(tparams))
    assert tleaves.keys() == jleaves.keys()
    names = set()
    for k, want in jleaves.items():
        got, name = tleaves[k], k.rsplit(".", 1)[-1]
        names.add(name)
        f32 = name in F32_LEAVES or name.endswith("norm")
        assert got.dtype == (torch.float32 if f32 else torch.bfloat16), k
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32), err_msg=k)
    if arch.startswith(("olmoe", "granite", "jamba")):
        assert {"router", "w_gate", "w_up", "w_down"} <= names
    if arch.startswith(("mamba", "jamba")):
        assert {"A_log", "D", "dt_bias", "in_x", "conv_x_w", "out_proj"} <= names
