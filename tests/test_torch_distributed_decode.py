"""The port's mesh decode (``prefill(mesh=)`` then ``decode_step(mesh=)``, the
cache placed by ``cache_specs``) on 4 gloo ranks (CPU) against the JAX
package's ``make_prefill_step`` and ``make_decode_step`` jitted with
``cache_specs`` shardings on 4 forced host devices, as its dry run jits them.

As ``tests/test_torch_distributed.py``, two programs run once per module in
subprocesses (this file, as a script): ``--oracle DIR`` (JAX, a (data 2,
model 2) mesh of ``AxisType.Auto`` axes) draws the weights and prompts and
computes the expected logits, greedy tokens and each cache leaf's shard
shape; ``--ranks DIR`` runs the port on 4 ranks over a ``file://`` store.
Cases, reduced and fp32, prompt of ``S`` tokens then ``STEPS`` greedy
tokens into a cache of ``MAX_SEQ`` slots: qwen3 at batch 4 (rows over data,
slots over model) and at batch 1 (slots over every axis), gemma2 with a
sliding window of 6 (a ring cut over model that wraps) and softcaps, jamba
(Mamba2 state by rows and heads beside attention and the MoE), whisper
(cross K/V by rows and encoder positions), and qwen3 with 1 KV head (the query heads cut over
model, each rank its KV head, in the prefill's attention). The ranks also
run the paged decode step's mesh route against its unsharded route.
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
# name -> (arch, overrides of the reduced config, batch); "window" re-sizes
# the sliding window of the windowed layers
CASES = {"qwen3-b4": ("qwen3-8b", {}, 4), "qwen3-b1": ("qwen3-8b", {}, 1),
         "gemma2": ("gemma2-27b", {"window": 6}, 4),
         "jamba": ("jamba-v0.1-52b", {}, 4), "whisper": ("whisper-tiny", {}, 4),
         "qwen3-kv1": ("qwen3-8b", {"n_kv_heads": 1}, 4)}
S, STEPS, MAX_SEQ = 8, 4, 16
# the paged step's mesh route against its unsharded route (port only): Mamba2
# state pools cut by heads, and pools of one KV head a rank (1 KV head, model 2)
PAGED = {"mamba2": ("mamba2-780m", {}), "jamba": ("jamba-v0.1-52b", {}),
         "qwen3-kv1": ("qwen3-8b", {"n_kv_heads": 1})}
PAGE, PAGED_STEPS = 4, 6
TIMEOUT = 600


def _cfg(get_config, reduced, name):
    arch, overrides, _ = CASES[name]
    cfg = reduced(get_config(arch))
    over = dict(overrides)
    if "window" in over:
        w = over.pop("window")
        over["block"] = tuple(dataclasses.replace(sp, window=w if sp.window else 0)
                              for sp in cfg.block)
    return dataclasses.replace(cfg, **over)


def _inputs(cfg, batch: int) -> dict:
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(batch, S)).astype(np.int32)}
    if cfg.encoder_layers:
        out["enc_frames"] = rng.normal(size=(batch, cfg.encoder_seq,
                                             cfg.d_model)).astype(np.float32)
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
    from repro.distributed.sharding import _path_str, cache_specs, data_spec, param_specs
    from repro.launch import steps as JS
    from repro.models import transformer as JT

    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {"shards": {}}

    def flat(tree) -> dict:
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {_path_str(p): x for p, x in leaves}

    def sh(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    for name, (_, _, batch) in CASES.items():
        cfg = _cfg(get_config, reduced, name)
        params = JT.init_params(jax.random.PRNGKey(0), cfg)
        arrays.update({f"{name}/params/{k}": np.asarray(v) for k, v in flat(params).items()})
        p_specs = param_specs(params, mesh, fsdp=False)
        struct = jax.eval_shape(lambda: JT.init_decode_cache(cfg, batch, MAX_SEQ))
        c_specs = cache_specs(struct, mesh, batch)
        inputs = _inputs(cfg, batch)
        bspec = data_spec(mesh, batch)
        batch_in = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, bspec))
                    for k, v in inputs.items()}
        params = jax.device_put(params, sh(p_specs))
        prefill = jax.jit(JS.make_prefill_step(cfg, MAX_SEQ, mesh),
                          in_shardings=(sh(p_specs), jax.tree.map(lambda _: NamedSharding(
                              mesh, bspec), batch_in)),
                          out_shardings=(None, sh(c_specs)))
        decode = jax.jit(JS.make_decode_step(cfg, mesh),
                         in_shardings=(sh(p_specs), sh(c_specs),
                                       {"tokens": NamedSharding(mesh, bspec)}),
                         out_shardings=(None, sh(c_specs)))
        logits, cache = prefill(params, batch_in)
        meta["shards"][name] = {k: list(v.sharding.shard_shape(v.shape))
                                for k, v in flat(cache).items()}
        steps, tokens = [np.asarray(logits)], []
        for _ in range(STEPS):
            tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
            tokens.append(np.asarray(tok))
            logits, cache = decode(params, cache, {"tokens": tok})
            steps.append(np.asarray(logits))
        arrays[f"{name}/logits"] = np.stack(steps)
        arrays[f"{name}/tokens"] = np.concatenate(tokens, axis=1)
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
    from repro_torch.distributed import distribute_tree, param_specs
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten_with_paths, map_with_path

    out = Path(out)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}", rank=rank,
                            world_size=world)
    arrays = dict(np.load(out / "oracle.npz"))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    got: dict[str, np.ndarray] = {}
    local = lambda t: t.to_local() if isinstance(t, DTensor) else t
    for name, (_, _, batch) in CASES.items():
        cfg = _cfg(get_config, reduced, name)
        like = T.init_params(cfg, torch.Generator(), device="meta")
        params = map_with_path(lambda k, _: torch.from_numpy(
            arrays[f"{name}/params/{k}"].copy()), like)
        params = distribute_tree(params, param_specs(params, mesh, fsdp=False), mesh)
        inputs = {k: torch.from_numpy(v) for k, v in _inputs(cfg, batch).items()}
        with torch.no_grad():
            logits, cache = T.prefill(params, inputs["tokens"], cfg, MAX_SEQ,
                                      enc_frames=inputs.get("enc_frames"), mesh=mesh)
            shards = {k: np.asarray(local(v).shape) for k, v in flatten_with_paths(cache).items()}
            steps, tokens = [logits], []
            for _ in range(STEPS):
                tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
                tokens.append(tok)
                logits, cache = T.decode_step(params, tok, cache, cfg, mesh=mesh)
                steps.append(logits)
        got[f"{name}/logits"] = torch.stack(steps).numpy()
        got[f"{name}/tokens"] = torch.cat(tokens, dim=1).numpy()
        got.update({f"{name}/shard/{k}": v for k, v in shards.items()})
        got.update({f"{name}/shard_after/{k}": np.asarray(local(v).shape)
                    for k, v in flatten_with_paths(cache).items()})
    for name, (arch, overrides) in PAGED.items():
        got.update({f"paged/{name}/{k}": v for k, v in _paged(
            dataclasses.replace(reduced(get_config(arch)), **overrides), mesh).items()})
    np.savez(out / f"rank{rank}.npz", **got)
    dist.destroy_process_group()


def _paged(cfg, mesh) -> dict:
    """``PAGED_STEPS`` steps of the paged decode step, unsharded and through
    ``mesh=`` (params by ``param_specs(fsdp=False)``, pools from
    ``init_pools(mesh=)``), on the same weights, tokens and page table, a
    row inactive: each route's logits."""
    import torch

    from repro_torch.distributed import distribute_tree, param_specs
    from repro_torch.models import transformer as T
    from repro_torch.serving.paged_model import init_pools, make_paged_decode_step

    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    b = 4
    table = torch.arange(b * 4, dtype=torch.int32).reshape(b, 4)
    active = torch.tensor([True, True, False, True])
    tokens = torch.randint(0, cfg.vocab, (PAGED_STEPS, b, 1),
                           generator=torch.Generator().manual_seed(1)).to(torch.int32)
    out = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        p = params if m is None else distribute_tree(params, param_specs(params, m, fsdp=False), m)
        pools = init_pools(cfg, num_pages=b * 4 + 1, page_size=PAGE, max_batch=b, mesh=m)
        step = make_paged_decode_step(cfg, page_size=PAGE, mesh=m)
        lengths = torch.tensor([0, 2, 0, 5], dtype=torch.int32)
        logits = []
        with torch.no_grad():
            for t in range(PAGED_STEPS):
                logits.append(step(p, pools, tokens[t], lengths, table, active))
                lengths = lengths + 1
        out[tag] = torch.stack(logits).numpy()
    return out


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
    out = tmp_path_factory.mktemp("dist_decode")
    res = _script("--oracle", out, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    assert res.returncode == 0, res.stderr[-4000:]
    res = _script("--ranks", out)
    assert res.returncode == 0, res.stderr[-4000:]
    return {"want": dict(np.load(out / "oracle.npz")),
            "meta": json.loads((out / "oracle.json").read_text()),
            "ranks": [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]}


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_decode_matches_jax(runs, name):
    """The prefill's last logits and each of the decode steps' within 5e-3
    of JAX's (``tests/test_models.py``'s limit), the greedy tokens
    identical, on every rank."""
    want = runs["want"]
    for r, got in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(got[f"{name}/tokens"], want[f"{name}/tokens"],
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"{name}/logits"], want[f"{name}/logits"], atol=5e-3,
                                   rtol=5e-3, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_cache_shards_match_cache_specs(runs, name):
    """Each rank's local cache leaves, after the prefill and after the last
    decode step, have the shard shapes JAX's ``cache_specs`` shardings give
    on the same mesh."""
    want = runs["meta"]["shards"][name]
    assert want
    for r, got in enumerate(runs["ranks"]):
        for when in ("shard", "shard_after"):
            have = {k[len(f"{name}/{when}/"):]: list(v) for k, v in got.items()
                    if k.startswith(f"{name}/{when}/")}
            assert have == want, (r, when)


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_step_mesh_route_matches_unsharded(runs, name):
    """The paged decode step through ``mesh=`` on (data 2, model 2): the
    Mamba2 state pools cut by heads, the K/V pools of one KV head a rank
    under ``layers.head_split`` "q"; 6 steps' logits within 1e-4 of the
    unsharded step's, on every rank."""
    for r, got in enumerate(runs["ranks"]):
        np.testing.assert_allclose(got[f"paged/{name}/mesh"], got[f"paged/{name}/plain"],
                                   atol=1e-4, rtol=1e-4, err_msg=f"rank {r}")


if __name__ == "__main__":
    mode, out_dir = sys.argv[1], Path(sys.argv[2])
    if mode == "--oracle":
        _oracle(out_dir)
    elif mode == "--ranks":
        _run_ranks(out_dir)
    else:
        raise SystemExit(f"unknown mode {mode}")
