"""Weights carried across from the JAX package.

``params_from_jax`` takes the JAX parameter tree with its leaves already
turned into numpy arrays (``jax.tree.map(np.asarray, params)``) and gives the
port's tree: the same keys, the same stacking over ``n_blocks``, and each
leaf's own dtype (in a bf16 model the norm scales, the MoE router and the
Mamba2 ``A_log``, ``D``, ``dt_bias`` and ``norm`` stay float32).
``opt_state_from_jax`` carries an optimizer state across the same way, and
``cache_state_from_jax`` an SA-cache state. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sa_cache import CacheState
from repro_torch.optim import AdamWState


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


def opt_state_from_jax(state, device=None) -> AdamWState:
    """A JAX ``repro.optim.AdamWState`` (or anything with its fields), its
    leaves numpy arrays or convertible to them, as the port's: ``step`` a 0-d
    int32 tensor, ``m``, ``v`` and ``master`` (None stays None) through
    ``params_from_jax``."""
    master = None if state.master is None else params_from_jax(state.master, device)
    return AdamWState(step=tensor_from_numpy(np.asarray(state.step, np.int32), device),
                      m=params_from_jax(state.m, device), v=params_from_jax(state.v, device),
                      master=master)


def cache_state_from_jax(state, device=None) -> CacheState:
    """A JAX ``repro.core.sa_cache.CacheState`` (or anything with its fields)
    as the port's, through numpy; an ``epoch`` of None stays None."""
    return CacheState(*(None if x is None else tensor_from_numpy(np.asarray(x), device)
                        for x in (state.tags, state.hits, state.dirty, state.clock,
                                  state.epoch)))
