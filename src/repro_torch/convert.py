"""Weights carried across from the JAX package.

``params_from_jax`` takes the JAX parameter tree with its leaves already
turned into numpy arrays (``jax.tree.map(np.asarray, params)``) and gives the
port's tree: the same keys, the same stacking over ``n_blocks``, and each
leaf's own dtype (norm scales stay float32 in a bf16 model). Nothing here
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy -> torch with the dtype kept. bf16 arrives as ``ml_dtypes``'
    bfloat16, which ``torch.from_numpy`` rejects: its bits go across as
    uint16 and are viewed as bfloat16 again."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(tree, device=None):
    """Map a tree of dicts/tuples/lists of numpy arrays onto torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(v, device) for v in tree)
    return tensor_from_numpy(np.asarray(tree), device)
