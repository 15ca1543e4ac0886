"""The port's dry-run inputs (``repro_torch.launch.specs``, fake tensors)
against the JAX package's (``repro.launch.specs``, ``jax.eval_shape``):
for every arch at its published size and every shape cell it runs, each
leaf of ``input_specs`` has the same shape and dtype. Leaves are matched in
JAX's pytree order (``repro_torch.tree``: dict keys sorted, NamedTuples by
field). Neither side allocates, so the published sizes cost nothing."""
from functools import lru_cache

import jax
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import specs as JS
from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.launch import specs as S
from repro_torch.tree import flatten_with_paths

CELLS = [(arch, shape) for arch in ARCH_IDS for shape in cells(arch)]


@lru_cache(maxsize=None)
def _jax_params(arch: str):
    return jax.tree.leaves(JS.params_specs(JS.get_config(arch)))


def _same(port: dict, jax_leaves: list, where: str) -> None:
    assert len(port) == len(jax_leaves), f"{where}: {len(port)} leaves, JAX {len(jax_leaves)}"
    for (key, got), want in zip(port.items(), jax_leaves):
        assert tuple(got.shape) == tuple(want.shape), f"{where} {key}: {got.shape} vs {want.shape}"
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), \
            f"{where} {key}: {got.dtype} vs {want.dtype}"


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax_eval_shape(arch, shape):
    port = S.input_specs(arch, SHAPES[shape])
    want = JS.input_specs(arch, JAX_SHAPES[shape])
    assert list(port) == list(want)
    for part in port:
        leaves = (_jax_params(arch) if part == "params"
                  else jax.tree.leaves(want[part]))
        _same(flatten_with_paths(port[part]), leaves, f"{arch} {shape} {part}")
    for t in flatten_with_paths(port).values():
        assert isinstance(t, torch._subclasses.fake_tensor.FakeTensor)


def test_specs_share_one_fake_mode_and_take_a_device():
    """Every leaf of one cell belongs to the mode it was made under, so the
    step can run on them under that mode, on the device asked for."""
    mode = torch._subclasses.fake_tensor.FakeTensorMode()
    cfg = get_config("qwen2-vl-72b")
    specs = S.input_specs("qwen2-vl-72b", SHAPES["decode_32k"], "meta", mode)
    for t in flatten_with_paths(specs).values():
        assert t.fake_mode is mode and t.device.type == "meta"
    assert tuple(specs["batch"]["positions"].shape) == (128, 3, 1)
    batch = S.prefill_batch_specs(cfg, SHAPES["prefill_32k"], "cpu", mode)
    assert batch["vis_embeds"].dtype == torch.bfloat16
    assert tuple(batch["positions"].shape) == (32, 3, 32768)
