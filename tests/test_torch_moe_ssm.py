"""The port's MoE and Mamba2 layers against the JAX package, one function at a
time, on the same numpy inputs and weights (reduced configs, float32); and the
parameter layout and converted dtypes of the MoE, Mamba2 and hybrid families."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

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
