"""The port's sharded train step for the families whose mesh routes
``tests/test_torch_distributed.py`` does not hold: reduced mamba2 and jamba
(the Mamba2 scan under ``local_map`` on a rank's rows and heads), gemma2
(a sliding window of 6, softcaps, post-norms), qwen2-vl (patch embeddings,
M-RoPE positions) and whisper (encoder, cross-attention). On 4 gloo ranks
(CPU) on (data 2, model 2) against the JAX package's sharded
``make_train_step`` on 4 forced host devices, 2 fp32 steps: the ce losses
within 5e-3 relative of JAX's and 1e-5 of the port's unsharded step, each
leaf's update within 1e-3 relative L2 of JAX's (the limits of
``tests/test_torch_distributed.py``). Two programs run once per module in
subprocesses (this file, as a script), as there.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
# name -> (arch, overrides of the reduced config); "window" re-sizes the
# sliding window of the windowed layers
TRAIN = {"mamba2": ("mamba2-780m", {}), "jamba": ("jamba-v0.1-52b", {}),
         "gemma2": ("gemma2-27b", {"window": 6}), "qwen2-vl": ("qwen2-vl-72b", {}),
         "whisper": ("whisper-tiny", {})}
B, S, STEPS = 4, 16, 2
HP = dict(peak_lr=1e-2, warmup=0, total_steps=10)
TIMEOUT = 600


def _cfg(get_config, reduced, name):
    arch, overrides = TRAIN[name]
    cfg = reduced(get_config(arch))
    over = dict(overrides)
    if "window" in over:
        w = over.pop("window")
        over["block"] = tuple(dataclasses.replace(sp, window=w if sp.window else 0)
                              for sp in cfg.block)
    return dataclasses.replace(cfg, **over)


def _batches(cfg) -> list[dict]:
    """numpy batches, with whisper's frames and qwen2-vl's patch embeddings
    and (B, 3, S) positions."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
        if cfg.encoder_layers:
            b["enc_frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.vis_tokens:
            b["vis_embeds"] = rng.normal(size=(B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
            b["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                                             (B, 3, S)).copy()
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# the JAX oracle (a subprocess with 4 host devices)
# ---------------------------------------------------------------------------

def _oracle(out: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config, reduced
    from repro.distributed.sharding import _path_str, param_specs
    from repro.launch import steps as JS
    from repro.models import transformer as JT
    from repro.optim import AdamWState, adamw_init

    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {"losses": {}}

    def flat(tree) -> dict:
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {_path_str(p): np.asarray(x) for p, x in leaves}

    def sh(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    for name in TRAIN:
        cfg = _cfg(get_config, reduced, name)
        params = JT.init_params(jax.random.PRNGKey(0), cfg)
        arrays.update({f"{name}/init/{k}": v for k, v in flat(params).items()})
        p_specs = param_specs(params, mesh)
        opt = adamw_init(params)
        o_specs = AdamWState(step=P(), m=p_specs, v=p_specs, master=None)
        params, opt = jax.device_put(params, sh(p_specs)), jax.device_put(opt, sh(o_specs))
        # shardings pinned both ways, so the second step reuses the first's program
        step = jax.jit(JS.make_train_step(cfg, mesh, remat=False, **HP),
                       in_shardings=(sh(p_specs), sh(o_specs), NamedSharding(mesh, P("data"))),
                       out_shardings=(sh(p_specs), sh(o_specs), None))
        losses = []
        for b in _batches(cfg):
            batch = jax.device_put(jax.tree.map(jnp.asarray, b), NamedSharding(mesh, P("data")))
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["ce"]))
        meta["losses"][name] = losses
        arrays.update({f"{name}/final/{k}": v for k, v in flat(params).items()})
    np.savez(out / "oracle.npz", **arrays)
    (out / "oracle.json").write_text(json.dumps(meta))


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _rank(rank: int, world: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config, reduced
    from repro_torch.data import make_global_batch
    from repro_torch.distributed import data_spec, distribute_tree, param_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten_with_paths, map_with_path

    out = Path(out)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}", rank=rank,
                            world_size=world)
    arrays = dict(np.load(out / "oracle.npz"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    got: dict[str, np.ndarray] = {}
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()
    for name in TRAIN:
        cfg = _cfg(get_config, reduced, name)
        like = T.init_params(cfg, torch.Generator(), device="meta")
        for sharded in (True, False):
            if not sharded and rank != 0:
                continue
            params = map_with_path(lambda k, _: torch.from_numpy(
                arrays[f"{name}/init/{k}"].copy()), like)
            if sharded:
                params = distribute_tree(params, param_specs(params, mesh), mesh)
            opt = adamw_init(params)
            step = make_train_step(cfg, mesh if sharded else None, remat=sharded, **HP)
            losses = []
            for b in _batches(cfg):
                batch = (make_global_batch(b, mesh, data_spec(mesh, B), "cpu") if sharded
                         else {k: torch.from_numpy(v) for k, v in b.items()})
                params, opt, metrics = step(params, opt, batch)
                losses.append(float(metrics["ce"]))
            tag = "sharded" if sharded else "plain"
            got[f"{name}/{tag}/losses"] = np.asarray(losses)
            if sharded:
                got.update({f"{name}/final/{k}": whole(v)
                            for k, v in flatten_with_paths(params).items()})
    np.savez(out / f"rank{rank}.npz", **got)
    dist.destroy_process_group()


def _run_ranks(out: Path) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(4, str(out)), nprocs=4)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def _script(mode: str, out: Path, **env) -> subprocess.CompletedProcess:
    full_env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", **env}
    return subprocess.run([sys.executable, __file__, mode, str(out)], env=full_env,
                          capture_output=True, text=True, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_families")
    res = _script("--oracle", out, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    assert res.returncode == 0, res.stderr[-4000:]
    res = _script("--ranks", out)
    assert res.returncode == 0, res.stderr[-4000:]
    return {"want": dict(np.load(out / "oracle.npz")),
            "meta": json.loads((out / "oracle.json").read_text()),
            "ranks": [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_jax(runs, name):
    """2 fp32 steps on (data 2, model 2): the ce losses within 5e-3
    relative of JAX's sharded ``make_train_step`` and within 1e-5 of the
    port's unsharded step; each leaf's update within 1e-3 relative L2 of
    JAX's; every rank saw the same losses and parameters."""
    want, got = runs["want"], runs["ranks"][0]
    jl = np.asarray(runs["meta"]["losses"][name])
    sharded, plain = got[f"{name}/sharded/losses"], got[f"{name}/plain/losses"]
    np.testing.assert_allclose(sharded, jl, rtol=5e-3)
    np.testing.assert_allclose(sharded, plain, rtol=1e-5)
    keys = [k[len(f"{name}/init/"):] for k in want if k.startswith(f"{name}/init/")]
    assert keys
    for k in keys:
        init = want[f"{name}/init/{k}"].astype(np.float64)
        rel = _rel_l2(got[f"{name}/final/{k}"] - init, want[f"{name}/final/{k}"] - init)
        assert rel <= 1e-3, (k, rel)
    for r in range(1, 4):
        other = runs["ranks"][r]
        np.testing.assert_array_equal(other[f"{name}/sharded/losses"], sharded)
        for k in keys:
            np.testing.assert_array_equal(other[f"{name}/final/{k}"], got[f"{name}/final/{k}"])


if __name__ == "__main__":
    mode, out_dir = sys.argv[1], Path(sys.argv[2])
    if mode == "--oracle":
        _oracle(out_dir)
    elif mode == "--ranks":
        _run_ranks(out_dir)
    else:
        raise SystemExit(f"unknown mode {mode}")
