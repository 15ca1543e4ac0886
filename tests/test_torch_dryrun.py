"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU route.

* Every arch x shape cell runs to its end on both production meshes,
  (16, 16) here and (2, 16, 16) in ``test_torch_dryrun_multi.py``, each on
  a fake process group of 256 or 512 ranks, and its record has the JSON
  keys JAX's dry run shares with it. The configs are reduced to one block
  of their pattern and one encoder layer (placements repeat layer by layer) and each cell keeps
  its mode and batch with a shorter sequence (``reduced_shape``: train
  and prefill 512, two Mamba2 chunks; a decode cache of 1,024, long_500k
  its own): the published shapes run in ``launch.dryrun --all``, minutes a
  sweep, and the test keeps to seconds.
* At a (1, 1) mesh no collective moves a byte and the per-device FLOPs are
  the unsharded step's.
* At (16, 16) a train cell whose every sharded dim divides by 16 counts the
  unsharded FLOPs / 256 per device, within 0.5 % (the loss's
  sum of squares and the router's small products are replicated).

The fake process group is process-global: ``run_cell`` ends it, and the
fixture here ends any group a test leaves, so no other test file on the
same worker inherits one.
"""
import dataclasses

import pytest
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, cells, get_config, reduced
from repro_torch.launch import dryrun

JAX_KEYS = {"arch", "shape", "mesh", "chips", "mode", "tag", "overrides", "flops_per_device",
            "bytes_per_device", "collectives", "memory", "roofline",
            "model_flops_per_device", "useful_flop_ratio"}
CELLS = [(arch, shape) for arch in ARCH_IDS for shape in cells(arch)]
SEQ = {"train": 512, "prefill": 512, "decode": 1024}


def reduced_overrides(arch: str, **extra) -> dict:
    """``reduced``'s fields, at one block of the pattern, as overrides of
    the published config."""
    full = get_config(arch)
    small = reduced(full, n_layers=len(full.block),
                    encoder_layers=1 if full.encoder_layers else 0, **extra)
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(full)
            if getattr(small, f.name) != getattr(full, f.name)}


def reduced_shape(name: str) -> ShapeConfig:
    shape = SHAPES[name]
    seq = shape.seq_len if shape.global_batch == 1 else SEQ[shape.mode]
    return ShapeConfig(name, seq, shape.global_batch, shape.mode)


def check_cell(arch: str, shape: str, mesh: str, out_dir) -> None:
    res = dryrun.run_cell(arch, reduced_shape(shape), mesh, device="cpu",
                          cfg_overrides=reduced_overrides(arch), out_dir=out_dir,
                          verbose=False)
    assert JAX_KEYS <= set(res)
    assert res["chips"] == (256 if mesh == "single" else 512)
    assert not dist.is_initialized()
    assert res["flops_per_device"] > 0 and res["bytes_per_device"] > 0
    assert res["memory"]["argument_bytes"] > 0
    assert set(res["roofline"]) >= {"compute_s", "memory_s", "collective_s", "bottleneck"}
    assert (out_dir / f"{arch}_{shape}_{mesh}.json").exists()
    assert set(res["collectives"]["by_axis"]) <= {"pod", "data", "model", "world"}
    assert "cache_layout" not in res        # the decode cache is JAX's layout now


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_reduced_cell_runs_on_single_mesh(arch, shape, tmp_path):
    check_cell(arch, shape, "single", tmp_path)


@pytest.mark.parametrize("arch,shape", [("qwen3-8b", "train_4k"), ("olmoe-1b-7b", "prefill_32k"),
                                        ("mamba2-780m", "decode_32k")])
def test_unit_mesh_moves_nothing_and_counts_the_unsharded_step(arch, shape):
    from torch.distributed.device_mesh import init_device_mesh

    over, shp = reduced_overrides(arch), reduced_shape(shape)
    alone = dryrun.count_cell(arch, shp, None, device="cpu", cfg_overrides=over)["counter"]
    dryrun.start_fake_group(1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    unit = dryrun.count_cell(arch, shp, mesh, device="cpu", cfg_overrides=over)["counter"]
    assert sum(unit.collective_bytes.values()) == 0
    assert unit.flops == alone.flops


def test_sharded_train_cell_counts_a_256th_per_device():
    over, shp = reduced_overrides("qwen3-8b", n_heads=16, n_kv_heads=16), reduced_shape("train_4k")
    alone = dryrun.count_cell("qwen3-8b", shp, None, device="cpu",
                              cfg_overrides=over)["counter"].flops
    res = dryrun.run_cell("qwen3-8b", shp, "single", device="cpu", cfg_overrides=over,
                          verbose=False)
    assert res["flops_per_device"] == pytest.approx(alone / 256, rel=5e-3)
    assert res["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-v0.1-52b", "whisper-tiny"])
def test_decode_cache_bytes_are_the_cache_specs_shards(arch):
    """A decode cell's cache on (16, 16), as the dry run builds it, holds on
    a rank the sum of its leaves' shards under the JAX package's
    ``cache_specs`` (each dim divided by the sizes of the mesh axes its
    spec names): the rows over ``data``, the KV sequence over ``model``,
    the Mamba2 state by heads, whisper's cross K/V too."""
    import math
    from types import SimpleNamespace

    import jax
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs import get_config as jax_get_config
    from repro.distributed import sharding as JS
    from repro.launch.specs import cache_specs_struct

    over, shp = reduced_overrides(arch), reduced_shape("decode_32k")
    sizes = {"data": 16, "model": 16}
    jcache = cache_specs_struct(dataclasses.replace(jax_get_config(arch), **over),
                                shp.global_batch, shp.seq_len)
    specs = JS.cache_specs(jcache, SimpleNamespace(shape=sizes), shp.global_batch)
    want = 0
    for leaf, spec in zip(jax.tree.leaves(jcache), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        dims = list(leaf.shape)
        for i, entry in enumerate(spec):
            for a in () if entry is None else (entry if isinstance(entry, tuple) else (entry,)):
                dims[i] //= sizes[a]
        want += math.prod(dims) * leaf.dtype.itemsize
    mesh = dryrun.production_mesh("single", "cpu")
    _, args, _, _ = dryrun.build_cell(arch, shp, mesh, device="cpu", mode=FakeTensorMode(),
                                      cfg_overrides=over)
    assert dryrun.local_bytes(args[1]) == want > 0
