"""The port's distribution on 4 gloo ranks (CPU) against the JAX package's
sharded functions on 4 forced host devices.

Once per module, two programs run in subprocesses (this file, as a script):
  * ``--oracle DIR``: JAX with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
    on meshes whose axes are ``AxisType.Auto`` (JAX's ``_constrain_batch``
    refuses ``Explicit`` axes). It draws the inputs (weights from
    ``init_params``, batches from numpy) and computes the expected outputs:
    the sharded train step (``make_train_step(cfg, mesh)``, 2 steps, fp32)
    of reduced qwen3-8b (with 2 KV heads, and with 1, which the model axis
    does not divide) and olmoe-1b-7b ("ep" and "tp") on (data 2, model 2),
    ``moe_ffn`` over that mesh at a capacity that drops, the compressed
    reduce under ``shard_map`` on (pod 2, data 2, model 1), each device's
    slice of ``NamedSharding``s, and a JAX checkpoint.
  * ``--ranks DIR``: 4 ranks of ``torch.multiprocessing`` over a ``file://``
    store (no port), then 2 ranks for the train driver; each rank writes
    what it computed.
The tests compare the two. The 4 ranks' meshes are built with
``init_device_mesh``, whose rank layout is row-major, as the JAX meshes'
device arrays are read here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
# name -> (arch, overrides of the reduced config); "qwen3-kv1": 1 KV head on
# a model axis of 2, so K/V are gathered over it (``layers.split_heads``),
# the heads replicated, and the merged heads' gradient is redistributed
# (``sharding.grad_in_placements``)
TRAIN = {"qwen3-8b": ("qwen3-8b", {}), "qwen3-kv1": ("qwen3-8b", {"n_kv_heads": 1}),
         "olmoe-ep": ("olmoe-1b-7b", {"moe_parallel": "ep"}),
         "olmoe-tp": ("olmoe-1b-7b", {"moe_parallel": "tp"})}
B, S, STEPS = 4, 16, 2
HP = dict(peak_lr=1e-2, warmup=0, total_steps=10)
MOE_B, MOE_S, MOE_CAPACITY = 4, 8, 0.5            # capacity 0.5: assignments drop
PLACED = [(("pod", "data"), None), (None, ("pod", "data")), ("data", None),
          (("pod", "data"), "model"), ("pod", "data")]
PLACED_SHAPE = (8, 12)
REDUCE_SHAPES = {"w": (8, 16), "b": (16,), "t": (2, 3, 16)}
TIMEOUT = 600


def _train_cfg(get_config, reduced, name):
    arch, overrides = TRAIN[name]
    return dataclasses.replace(reduced(get_config(arch)), **overrides)


def _moe_cfg(get_config, reduced, mode):
    return dataclasses.replace(reduced(get_config("olmoe-1b-7b")), moe_parallel=mode,
                               moe_capacity_factor=MOE_CAPACITY)


def _batches(vocab: int) -> list[dict]:
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": (rng.random((B, S)) > 0.1).astype(np.float32)})
    return out


def _reduce_grads(round_: int) -> dict:
    """Each of the 4 ranks' gradients (stacked on dim 0) for one round."""
    rng = np.random.default_rng(100 + round_)
    return {k: rng.normal(size=(4, *shape)).astype(np.float32)
            for k, shape in REDUCE_SHAPES.items()}


# ---------------------------------------------------------------------------
# the JAX oracle (a subprocess with 4 host devices)
# ---------------------------------------------------------------------------

def _oracle(out: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.checkpoint import CheckpointManager
    from repro.configs import get_config, reduced
    from repro.distributed.collectives import CompressionState, cross_pod_grad_reduce
    from repro.distributed.sharding import _path_str, param_specs
    from repro.launch import steps as JS
    from repro.models import transformer as JT
    from repro.models.moe import init_moe, moe_ffn
    from repro.optim import AdamWState, adamw_init

    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    mesh3 = jax.make_mesh((2, 2, 1), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {"losses": {}, "placed": []}

    def flat(tree) -> dict:
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {_path_str(p): np.asarray(x) for p, x in leaves}

    def sh(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    for name in TRAIN:
        cfg = _train_cfg(get_config, reduced, name)
        params = JT.init_params(jax.random.PRNGKey(0), cfg)
        arrays.update({f"{name}/init/{k}": v for k, v in flat(params).items()})
        p_specs = param_specs(params, mesh)
        opt = adamw_init(params)
        o_specs = AdamWState(step=P(), m=p_specs, v=p_specs, master=None)
        params, opt = jax.device_put(params, sh(p_specs)), jax.device_put(opt, sh(o_specs))
        step = jax.jit(JS.make_train_step(cfg, mesh, remat=False, **HP))
        losses = []
        for b in _batches(cfg.vocab):
            batch = jax.device_put(jax.tree.map(jnp.asarray, b), NamedSharding(mesh, P("data")))
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["ce"]))
        meta["losses"][name] = losses
        arrays.update({f"{name}/final/{k}": v for k, v in flat(params).items()})

    for mode in ("ep", "tp"):
        cfg = _moe_cfg(get_config, reduced, mode)
        x = np.random.default_rng(3).normal(size=(MOE_B, MOE_S, cfg.d_model)).astype(np.float32)
        p = init_moe(jax.random.PRNGKey(1), cfg)
        f = jax.jit(lambda x, p, cfg=cfg: moe_ffn(x, p, cfg, mesh=mesh))
        y, aux = f(jnp.asarray(x), p)
        arrays[f"moe-{mode}/y1"] = np.asarray(f(jnp.asarray(x[:1]), p)[0])   # dp does not divide
        arrays[f"moe-{mode}/x"] = x
        arrays.update({f"moe-{mode}/params/{k}": np.asarray(v) for k, v in p.items()})
        arrays[f"moe-{mode}/y"] = np.asarray(y)
        arrays.update({f"moe-{mode}/{k}": np.asarray(v) for k, v in aux.items()})

    spec = P(("pod", "data"))
    for compress in (True, False):
        def fn(g, r, compress=compress):
            g, r = jax.tree.map(lambda a: a[0], g), jax.tree.map(lambda a: a[0], r)
            out, st = cross_pod_grad_reduce(g, CompressionState(r), mesh3, compress=compress)
            return jax.tree.map(lambda a: a[None], out), jax.tree.map(lambda a: a[None],
                                                                      st.residual)

        f = jax.jit(shard_map(fn, mesh=mesh3, in_specs=(spec, spec), out_specs=(spec, spec),
                              check_rep=False))
        res = {k: jnp.zeros((4, *s), jnp.float32) for k, s in REDUCE_SHAPES.items()}
        for round_ in range(2):
            red, res = f({k: jnp.asarray(v) for k, v in _reduce_grads(round_).items()}, res)
            for k in REDUCE_SHAPES:
                arrays[f"reduce-{compress}/{round_}/out/{k}"] = np.asarray(red[k])
                arrays[f"reduce-{compress}/{round_}/res/{k}"] = np.asarray(res[k])

    for entries in PLACED:
        index = NamedSharding(mesh3, P(*entries)).devices_indices_map(PLACED_SHAPE)
        per_rank = []
        for coord in np.ndindex(mesh3.devices.shape):       # row-major: the torch rank order
            sl = index[mesh3.devices[coord]]
            per_rank.append([[s.start or 0, PLACED_SHAPE[d] if s.stop is None else s.stop]
                             for d, s in enumerate(sl)])
        meta["placed"].append(per_rank)

    ckpt = CheckpointManager(out / "jax_ckpt")
    cfg = _train_cfg(get_config, reduced, "qwen3-8b")
    ckpt.save_async(0, JT.init_params(jax.random.PRNGKey(0), cfg))
    ckpt.drain()
    ckpt.close()
    np.savez(out / "oracle.npz", **arrays)
    (out / "oracle.json").write_text(json.dumps(meta))


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _init(rank: int, world: int, store: Path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)


def _from_arrays(like, arrays, prefix: str):
    """``like``'s tree holding ``arrays[prefix + key]`` as tensors."""
    import torch

    from repro_torch.tree import map_with_path

    return map_with_path(lambda k, _: torch.from_numpy(arrays[f"{prefix}{k}"].copy()), like)


def _rank(rank: int, world: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import make_global_batch
    from repro_torch.distributed import (CompressionState, cross_pod_grad_reduce, data_spec,
                                         distribute_tree, param_specs, placements)
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import moe_ffn
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten_with_paths, leaves

    out = Path(out)
    _init(rank, world, out / "store4")
    arrays = dict(np.load(out / "oracle.npz"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    mesh3 = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
    got: dict[str, np.ndarray] = {}
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()

    placed = np.arange(np.prod(PLACED_SHAPE), dtype=np.float32).reshape(PLACED_SHAPE)
    for i, entries in enumerate(PLACED):
        dt = distribute_tensor(torch.from_numpy(placed), mesh3, placements(P(*entries), mesh3),
                               src_data_rank=None)
        got[f"placed/{i}"] = dt.to_local().numpy()

    for name in TRAIN:
        cfg = _train_cfg(get_config, reduced, name)
        like = T.init_params(cfg, torch.Generator(), device="meta")
        for sharded in (True, False):
            params = _from_arrays(like, arrays, f"{name}/init/")
            m = mesh if sharded else None
            if sharded:
                params = distribute_tree(params, param_specs(params, mesh), mesh)
            elif rank != 0:
                continue
            opt = adamw_init(params)
            step = make_train_step(cfg, m, remat=sharded, **HP)
            losses = []
            for b in _batches(cfg.vocab):
                batch = (make_global_batch(b, mesh, data_spec(mesh, B), "cpu") if sharded
                         else {k: torch.from_numpy(v) for k, v in b.items()})
                params, opt, metrics = step(params, opt, batch)
                losses.append(float(metrics["ce"]))
            tag = "sharded" if sharded else "plain"
            got[f"{name}/{tag}/losses"] = np.asarray(losses)
            for k, v in flatten_with_paths(params).items():
                got[f"{name}/{tag}/final/{k}"] = whole(v)

    for mode in ("ep", "tp"):
        cfg = _moe_cfg(get_config, reduced, mode)
        p = {k: torch.from_numpy(arrays[f"moe-{mode}/params/{k}"].copy())
             for k in ("router", "w_gate", "w_up", "w_down")}
        specs = param_specs({"moe": p}, mesh)["moe"]
        dp = {k: distribute_tensor(v, mesh, placements(specs[k], mesh), src_data_rank=None)
              for k, v in p.items()}
        x = distribute_tensor(torch.from_numpy(arrays[f"moe-{mode}/x"].copy()), mesh,
                              placements(P("data"), mesh), src_data_rank=None)
        with torch.no_grad():
            y, aux = moe_ffn(x, dp, cfg, mesh=mesh)
            y1, _ = moe_ffn(torch.from_numpy(arrays[f"moe-{mode}/x"][:1].copy()), dp, cfg,
                            mesh=mesh)
        got[f"moe-{mode}/y"] = whole(y)
        got[f"moe-{mode}/y1"] = whole(y1)
        got.update({f"moe-{mode}/{k}": whole(v) for k, v in aux.items()})

    for compress in (True, False):
        state = CompressionState(residual={k: torch.zeros(s) for k, s in REDUCE_SHAPES.items()})
        for round_ in range(2):
            g = {k: torch.from_numpy(v[rank].copy()) for k, v in _reduce_grads(round_).items()}
            red, state = cross_pod_grad_reduce(g, state, mesh3, compress=compress)
            for k in REDUCE_SHAPES:
                got[f"reduce-{compress}/{round_}/out/{k}"] = red[k].numpy()
                got[f"reduce-{compress}/{round_}/res/{k}"] = state.residual[k].numpy()

    # a sharded save restores unsharded bitwise; a JAX checkpoint restores sharded
    cfg = _train_cfg(get_config, reduced, "qwen3-8b")
    like = T.init_params(cfg, torch.Generator(), device="meta")
    init = _from_arrays(like, arrays, "qwen3-8b/init/")
    specs = param_specs(init, mesh)
    sharded = distribute_tree(init, specs, mesh)
    ckpt = CheckpointManager(out / "port_ckpt")
    ckpt.save_async(3, sharded)
    ckpt.drain()
    dist.barrier()
    if rank == 0:
        _, plain = ckpt.restore(_from_arrays(like, arrays, "qwen3-8b/init/"))
        got["ckpt/unsharded_bitwise"] = np.asarray(all(
            torch.equal(a, b) and a.dtype == b.dtype and not isinstance(a, DTensor)
            for a, b in zip(leaves(plain), leaves(init))))
    ckpt.close()
    jax_ckpt = CheckpointManager(out / "jax_ckpt")
    _, restored = jax_ckpt.restore(init, shardings=specs, mesh=mesh)
    jax_ckpt.close()
    got["ckpt/jax_sharded_equal"] = np.asarray(all(
        isinstance(r, DTensor) and r.placements == s.placements
        and torch.equal(r.full_tensor(), a)
        for r, s, a in zip(leaves(restored), leaves(sharded), leaves(init))))
    np.savez(out / f"rank{rank}.npz", **got)
    dist.destroy_process_group()


def _driver(rank: int, world: int, out: str) -> None:
    """``launch.train.main`` at world 2 in a group this caller started."""
    import torch.distributed as dist

    from repro_torch.launch import train

    out = Path(out)
    _init(rank, world, out / "store2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--device", "cpu", "--preset", "smoke", "--steps", "30", "--batch", "8",
                    "--seq", "32", "--lr", "3e-3", "--ckpt-dir", str(out / "driver_ckpt"),
                    "--ckpt-every", "10", "--log-every", "10"])
    (out / f"driver{rank}.txt").write_text(buf.getvalue())
    dist.destroy_process_group()


def _run_ranks(out: Path) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(4, str(out)), nprocs=4)
    mp.spawn(_driver, args=(2, str(out)), nprocs=2)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _script(mode: str, out: Path, **env) -> subprocess.CompletedProcess:
    full_env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", **env}
    return subprocess.run([sys.executable, __file__, mode, str(out)], env=full_env,
                          capture_output=True, text=True, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    res = _script("--oracle", out, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    assert res.returncode == 0, res.stderr[-4000:]
    res = _script("--ranks", out)
    assert res.returncode == 0, res.stderr[-4000:]
    return {"out": out, "want": dict(np.load(out / "oracle.npz")),
            "meta": json.loads((out / "oracle.json").read_text()),
            "ranks": [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_placements_match_jax(runs):
    """Each rank's local shard of a leaf placed by ``P(("pod", "data"), ...)``
    (and the others of ``PLACED``) on (pod 2, data 2, model 1) is the slice
    JAX's ``NamedSharding.devices_indices_map`` gives that device."""
    full = np.arange(np.prod(PLACED_SHAPE), dtype=np.float32).reshape(PLACED_SHAPE)
    for i, per_rank in enumerate(runs["meta"]["placed"]):
        for r, bounds in enumerate(per_rank):
            want = full[tuple(slice(a, b) for a, b in bounds)]
            np.testing.assert_array_equal(runs["ranks"][r][f"placed/{i}"], want,
                                          err_msg=f"{PLACED[i]} rank {r}")


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_jax(runs, name):
    """2 fp32 steps on (data 2, model 2): the ce losses within 5e-3
    relative of JAX's sharded ``make_train_step`` and within 1e-5 of the
    port's unsharded step; each leaf's update within 1e-3 relative L2 of
    JAX's (``tests/test_torch_train_steps.py``'s limits)."""
    want, got = runs["want"], runs["ranks"][0]
    jl = np.asarray(runs["meta"]["losses"][name])
    sharded, plain = got[f"{name}/sharded/losses"], got[f"{name}/plain/losses"]
    np.testing.assert_allclose(sharded, jl, rtol=5e-3)
    np.testing.assert_allclose(sharded, plain, rtol=1e-5)
    keys = [k[len(f"{name}/init/"):] for k in want if k.startswith(f"{name}/init/")]
    assert keys
    for k in keys:
        init = want[f"{name}/init/{k}"].astype(np.float64)
        rel = _rel_l2(got[f"{name}/sharded/final/{k}"] - init, want[f"{name}/final/{k}"] - init)
        assert rel <= 1e-3, (k, rel)
    for r in range(1, 4):          # every rank saw the same losses and params
        np.testing.assert_array_equal(runs["ranks"][r][f"{name}/sharded/losses"], sharded)


@pytest.mark.parametrize("mode", ["ep", "tp"])
def test_moe_ffn_matches_jax(runs, mode):
    """``moe_ffn`` over (data 2, model 2) equals JAX's sharded ``moe_ffn``
    within 2e-5 (output, lb and z), at a capacity (per shard, as JAX's) at
    which assignments drop; and for a plain batch of one row, which the
    data axis does not divide (every rank runs it whole)."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.moe import _capacity, dispatch, route

    want, got = runs["want"], runs["ranks"][0]
    for k in ("y", "lb", "z", "y1"):
        np.testing.assert_allclose(got[f"moe-{mode}/{k}"], want[f"moe-{mode}/{k}"], atol=2e-5,
                                   rtol=2e-5, err_msg=k)
    cfg = _moe_cfg(get_config, reduced, mode)
    x = torch.from_numpy(want[f"moe-{mode}/x"])
    router = {"router": torch.from_numpy(want[f"moe-{mode}/params/router"])}
    dropped = 0
    for shard in x.chunk(2):                       # the dp shards' tokens
        xf = shard.reshape(-1, cfg.d_model)
        _, idx, _ = route(xf, router, cfg)
        keep, _ = dispatch(idx, cfg.moe_experts, _capacity(xf.shape[0], cfg))
        dropped += int((~keep).sum())
    assert dropped > 0


def test_cross_pod_grad_reduce_matches_jax(runs):
    """On (pod 2, data 2, model 1), two rounds: each rank's reduced
    gradients and error-feedback residuals equal JAX's under ``shard_map``
    within 1e-6; with ``compress=False`` the output is the exact mean."""
    want = runs["want"]
    for compress in (True, False):
        for round_ in range(2):
            grads = _reduce_grads(round_)
            for r, got in enumerate(runs["ranks"]):
                for k in REDUCE_SHAPES:
                    for part in ("out", "res"):
                        key = f"reduce-{compress}/{round_}/{part}/{k}"
                        np.testing.assert_allclose(got[key], want[key][r], atol=1e-6, rtol=0,
                                                   err_msg=f"{key} rank {r}")
                    if not compress:
                        np.testing.assert_allclose(
                            got[f"reduce-False/{round_}/out/{k}"], grads[k].mean(0),
                            atol=1e-6, rtol=0)


def test_quantize_matches_jax():
    """``_quantize`` / ``_dequantize`` equal JAX's bitwise (round half to
    even on both sides), ties included."""
    import jax.numpy as jnp
    import torch

    from repro.distributed.collectives import _dequantize as jdeq, _quantize as jq
    from repro_torch.distributed.collectives import _dequantize, _quantize

    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 256)).astype(np.float32)
    x[0, :4] = [127.0, 63.5, -0.5, 1.5]            # x / scale lands on .5 exactly
    q, s = _quantize(torch.from_numpy(x))
    jqv, js = jq(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_dequantize(q, s).numpy(), np.asarray(jdeq(jqv, js)))


def test_compression_error_feedback_reduces_error():
    """Port of ``tests/test_distributed.py``'s test: the quantization error
    is at most a scale, and error feedback recovers the residual over
    steps."""
    import torch

    from repro_torch.distributed.collectives import _dequantize, _quantize

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 256)).astype(np.float32))
    q, s = _quantize(x)
    err = x - _dequantize(q, s)
    assert float(err.abs().max()) <= float(s.max())
    total = torch.zeros_like(x)
    res = torch.zeros_like(x)
    for _ in range(8):
        q, s = _quantize(x + res)
        dq = _dequantize(q, s)
        res = x + res - dq
        total = total + dq
    np.testing.assert_allclose((total / 8).numpy(), x.numpy(), atol=2e-2)


def test_sharded_checkpoint_restores_unsharded(runs):
    """A save of DTensors on (data 2, model 2) (rank 0 writes) restores into
    plain tensors bitwise."""
    assert bool(runs["ranks"][0]["ckpt/unsharded_bitwise"])


def test_jax_checkpoint_restores_sharded(runs):
    """A JAX checkpoint restores onto the mesh by ``param_specs``: every rank
    gets DTensors with the rules' placements whose whole values are JAX's."""
    for got in runs["ranks"]:
        assert bool(got["ckpt/jax_sharded_equal"])


def test_train_driver_world_2(runs):
    """``launch.train.main`` at world 2 on gloo (the params FSDP-sharded
    over data 2) trains 30 smoke steps; rank 0 prints the falling loss, and
    rank 1 prints nothing."""
    text = (runs["out"] / "driver0.txt").read_text()
    assert "(DOWN)" in text, text
    assert (runs["out"] / "driver1.txt").read_text() == ""


if __name__ == "__main__":
    mode, out_dir = sys.argv[1], Path(sys.argv[2])
    if mode == "--oracle":
        _oracle(out_dir)
    elif mode == "--ranks":
        _run_ranks(out_dir)
    else:
        raise SystemExit(f"unknown mode {mode}")
