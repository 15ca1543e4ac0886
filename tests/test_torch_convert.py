"""JAX parameter trees carried into the port leaf for leaf: same keys, same
stacking, same shape, same dtype, same bits."""
import numpy as np
import pytest

import jax
import torch

from repro.configs import get_config, reduced
from repro.models import transformer as JT
from repro_torch.convert import params_from_jax, tensor_from_numpy


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_every_leaf(arch, dtype):
    cfg = reduced(get_config(arch), dtype=dtype)
    jparams = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), cfg))
    want = dict(_leaves(jparams))
    got = dict(_leaves(params_from_jax(jparams)))
    assert got.keys() == want.keys()
    assert isinstance(params_from_jax(jparams)["blocks"], tuple)
    for k, a in want.items():
        t = got[k]
        assert tuple(t.shape) == a.shape, k
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name, k
        bits = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        back = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
        np.testing.assert_array_equal(back.numpy(), bits, err_msg=k)
    # norm scales stay float32 in a bf16 model, matrices take the config dtype
    assert got["blocks.0.norm"].dtype == torch.float32
    assert got["blocks.0.attn.wq"].dtype == getattr(torch, dtype)


def test_non_contiguous_arrays_convert():
    a = np.arange(12, dtype=np.float32).reshape(3, 4).T
    np.testing.assert_array_equal(tensor_from_numpy(a).numpy(), a)
