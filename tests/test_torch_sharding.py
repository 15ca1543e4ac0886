"""The port's sharding rules against the JAX package's, with no process group:
``param_specs`` (FSDP and serving layouts) for every arch at its published
size, ``cache_specs`` at batch 1 and at a batch the data-parallel axes
divide, and ``data_spec``, on the meshes (1, 1), (2, 2), (16, 16) and
(2, 16, 16). The rules read only the mesh's axis sizes, so both sides take a
shape-only mesh (JAX: ``SimpleNamespace(shape=...)``; the port: its
``MeshShape``) and shape-only trees (``jax.eval_shape``; meta tensors)."""
from functools import lru_cache
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as JS
from repro.launch.specs import cache_specs_struct, params_specs
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.tree import flatten_with_paths

MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@lru_cache(maxsize=None)
def _jax_params(arch: str):
    return params_specs(jax_get_config(arch))


@lru_cache(maxsize=None)
def _port_params(arch: str):
    return T.init_params(get_config(arch), torch.Generator(), device="meta")


def _jax_flat(tree) -> dict:
    """{path key: spec entries} of a JAX spec tree, keys by JAX's ``_path_str``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {JS._path_str(path): tuple(spec) for path, spec in flat}


def _port_flat(tree) -> dict:
    return {key: tuple(spec) for key, spec in flatten_with_paths(tree).items()}


def _meshes(name: str):
    return SimpleNamespace(shape=MESHES[name]), MeshShape(MESHES[name])


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "serving"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh_name, fsdp):
    """Every leaf's spec equals JAX's, entry for entry, at the published size."""
    jmesh, mesh = _meshes(mesh_name)
    want = _jax_flat(JS.param_specs(_jax_params(arch), jmesh, fsdp=fsdp))
    got = _port_flat(S.param_specs(_port_params(arch), mesh, fsdp=fsdp))
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch, mesh_name):
    """``cache_specs`` equals JAX's on ``cache_specs_struct`` at batch 1 (the
    KV sequence over every axis) and at a batch the dp axes divide."""
    jmesh, mesh = _meshes(mesh_name)
    dp = MESHES[mesh_name].get("pod", 1) * MESHES[mesh_name]["data"]
    for batch in (1, 2 * dp):
        jcache = cache_specs_struct(jax_get_config(arch), batch, 256)
        cache = T.init_decode_cache(get_config(arch), batch, 256, device="meta")
        want = _jax_flat(JS.cache_specs(jcache, jmesh, batch))
        assert _port_flat(S.cache_specs(cache, mesh, batch)) == want, batch


def _case_fix_divisibility():
    fake = MeshShape({"data": 16, "model": 16})
    assert S._fix_divisibility(S.P("model", "data"), (51865, 384), fake) == S.P(None, "data")
    pod = MeshShape({"pod": 2, "data": 16, "model": 16})
    assert (S._fix_divisibility(S.P(("pod", "data"), "model"), (64, 64), pod)
            == S.P(("pod", "data"), "model"))
    assert S._fix_divisibility(S.P(("pod", "data"), None), (16, 3), pod) == S.P("pod", None)


def _case_param_specs_structure():
    mesh = MeshShape({"data": 1, "model": 1})
    for arch in ["tinyllama-1.1b", "jamba-v0.1-52b", "whisper-tiny"]:
        params = T.init_params(reduced(get_config(arch)), torch.Generator(), device="meta")
        specs = S.param_specs(params, mesh)
        assert list(flatten_with_paths(specs)) == list(flatten_with_paths(params))


def _case_data_spec():
    for name in MESHES:
        jmesh, mesh = _meshes(name)
        for batch in (1, 2, 3, 4, 8, 16, 32, 48):
            assert tuple(S.data_spec(mesh, batch)) == tuple(JS.data_spec(jmesh, batch)), (
                name, batch)


def _case_production_mesh():
    assert make_production_mesh().shape == MESHES["16x16"]
    assert make_production_mesh(multi_pod=True).shape == MESHES["2x16x16"]


def _case_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape(MESHES["2x16x16"])
    assert S.placements(S.P(("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert S.placements(S.P(None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError):
        S.placements(S.P(("data", "pod")), mesh)     # DTensor cuts in mesh order only


@pytest.mark.parametrize("case", [_case_fix_divisibility, _case_param_specs_structure,
                                  _case_data_spec, _case_production_mesh, _case_placements],
                         ids=lambda f: f.__name__[6:])
def test_spec_helpers(case):
    """The ``tests/test_distributed.py`` rule tests, ported, and the mesh
    helpers: ``_fix_divisibility`` drops axes that do not divide, the spec
    tree has the params' structure, ``data_spec`` equals JAX's, the
    production meshes' shapes, and a spec's DTensor placements."""
    case()


def test_constrain_skips_only_a_redistribute_that_moves_nothing():
    """On a (2, 2) mesh of a fake group: ``constrain`` hands back the same
    DTensor when it already has the placements and no gradient is
    recorded; under autograd it still redistributes (the gradient's
    placements are pinned on the way back), and a change of placements
    always does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.dryrun import start_fake_group

    start_fake_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        spec = S.P("data", None)
        x = distribute_tensor(torch.zeros(4, 8), mesh, S.placements(spec, mesh),
                              src_data_rank=None)
        assert S.constrain(x, mesh, spec) is x
        with torch.no_grad():
            assert S.constrain(x.requires_grad_(), mesh, spec) is x
        y = S.constrain(x, mesh, spec)
        assert y is not x and y.grad_fn is not None
        with torch.no_grad():
            z = S.constrain(x, mesh, S.P(None, "model"))
        assert z.placements == tuple(S.placements(S.P(None, "model"), mesh))
    finally:
        dist.destroy_process_group()
