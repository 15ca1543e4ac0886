"""Shape-only stand-ins for every model input, the dry-run's feed; the
port's twin of ``repro/launch/specs.py``.

JAX's ``ShapeDtypeStruct`` is PyTorch's fake tensor: a tensor under a
``FakeTensorMode`` has a shape, a dtype and a device and holds no memory,
and operators run on it compute only their outputs' shapes. Each function
here takes the ``FakeTensorMode`` its tensors belong to (a new one if none
is given): the step they feed must run under the same mode.
``params_specs`` runs the port's ``init_params`` under the mode, and
``cache_specs_struct`` its ``init_decode_cache``, so the specs are the
trees those functions return, leaf for leaf.

Modality frontends are stubs, as in JAX: whisper gets precomputed conv
frames (``enc_frames`` f32), qwen2-vl precomputed patch embeddings
(``vis_embeds`` in the config dtype) and (t, h, w) M-RoPE position ids
(``positions`` (B, 3, S)).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.configs.base import ModelConfig


def _mode(mode: FakeTensorMode | None) -> FakeTensorMode:
    return mode if mode is not None else FakeTensorMode()


def _empty(mode, shape, dtype, device):
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


def _modality(cfg: ModelConfig, b: int, s: int, mode, device) -> dict:
    out = {}
    if cfg.encoder_layers:
        out["enc_frames"] = _empty(mode, (b, cfg.encoder_seq, cfg.d_model), torch.float32,
                                   device)
    if cfg.vis_tokens:
        out["vis_embeds"] = _empty(mode, (b, cfg.vis_tokens, cfg.d_model),
                                   getattr(torch, cfg.dtype), device)
        out["positions"] = _empty(mode, (b, 3, s), torch.int32, device)
    return out


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, device="cpu",
                      mode: FakeTensorMode | None = None) -> dict:
    mode = _mode(mode)
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _empty(mode, (b, s), torch.int32, device),
            "labels": _empty(mode, (b, s), torch.int32, device),
            "mask": _empty(mode, (b, s), torch.float32, device),
            **_modality(cfg, b, s, mode, device)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig, device="cpu",
                        mode: FakeTensorMode | None = None) -> dict:
    mode = _mode(mode)
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": _empty(mode, (b, s), torch.int32, device),
            **_modality(cfg, b, s, mode, device)}


def decode_batch_specs(cfg: ModelConfig, shape: ShapeConfig, device="cpu",
                       mode: FakeTensorMode | None = None) -> dict:
    mode = _mode(mode)
    b = shape.global_batch
    out = {"tokens": _empty(mode, (b, 1), torch.int32, device)}
    if cfg.mrope_sections:
        out["positions"] = _empty(mode, (b, 3, 1), torch.int32, device)
    return out


def params_specs(cfg: ModelConfig, device="cpu", mode: FakeTensorMode | None = None) -> dict:
    """``init_params`` under the fake mode: the parameter tree's shapes and
    dtypes, no allocation."""
    from repro_torch.models.transformer import init_params

    with _mode(mode):      # no generator: a fake draw reads none, on any device
        return init_params(cfg, None, device)


def cache_specs_struct(cfg: ModelConfig, batch: int, max_seq: int, device="cpu",
                       mode: FakeTensorMode | None = None, mesh=None):
    """``init_decode_cache`` under the fake mode (with a ``mesh``, a rank's
    cache, as ``init_decode_cache(mesh=)`` makes it)."""
    from repro_torch.models.transformer import init_decode_cache

    with _mode(mode):
        return init_decode_cache(cfg, batch, max_seq, device, mesh=mesh)


def input_specs(arch: str, shape: ShapeConfig, device="cpu",
                mode: FakeTensorMode | None = None) -> dict:
    """All step inputs of one (arch x shape) cell, as fake tensors of one
    mode on ``device``: ``params`` and ``batch``, and ``cache`` for a
    decode shape."""
    cfg = get_config(arch)
    mode = _mode(mode)
    if shape.mode == "train":
        return {"params": params_specs(cfg, device, mode),
                "batch": train_batch_specs(cfg, shape, device, mode)}
    if shape.mode == "prefill":
        return {"params": params_specs(cfg, device, mode),
                "batch": prefill_batch_specs(cfg, shape, device, mode)}
    return {"params": params_specs(cfg, device, mode),
            "cache": cache_specs_struct(cfg, shape.global_batch, shape.seq_len, device, mode),
            "batch": decode_batch_specs(cfg, shape, device, mode)}
