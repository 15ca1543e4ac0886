"""Mesh builders, the port's twin of ``repro/launch/mesh.py``.

Functions, never module-level meshes: importing this module starts no
process group. A mesh is a ``torch.distributed.DeviceMesh`` with named dims,
or a ``MeshShape``, a mesh of named sizes only, which the sharding rules
accept as JAX's accept any object with a ``shape`` (so the rules run at the
production shapes without 512 processes).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class MeshShape:
    """A mesh of named axis sizes and no devices: ``shape`` maps each axis,
    in mesh order, to its size, as a JAX mesh's ``shape`` does."""

    shape: dict


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (its dim names) or of anything
    with a ``shape`` dict (``MeshShape``, a JAX mesh)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if not isinstance(getattr(mesh, "shape", None), dict):
        raise TypeError(f"not a mesh: {mesh!r} (a DeviceMesh with named dims, or an object "
                        "whose shape is a dict of axis sizes)")
    return dict(mesh.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 single-pod (256 cards) or 2 x 16 x 16 two-pod (512 cards), as
    a ``MeshShape``: what the sharding rules read. On a process group of
    that world, ``init_device_mesh(device, shape, mesh_dim_names=axes)`` of
    ``PRODUCTION_SHAPES`` is the same mesh with devices.

    Axes: ``data`` = FSDP + DP + EP, ``model`` = TP, ``pod`` = cross-pod DP
    (the compressed gradient reduce of ``distributed/collectives.py``)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return MeshShape(dict(zip(axes, shape)))


def init_process_group(device: str, *, init_method: str | None = None, rank: int | None = None,
                       world_size: int | None = None) -> None:
    """Start the default process group if none runs: nccl for a CUDA device,
    gloo for the CPU. ``init_method`` (``file://...`` or ``tcp://...``),
    ``rank`` and ``world_size`` default to what ``torchrun`` sets
    (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); with none of
    them set it is a group of one over a ``tcp://127.0.0.1`` store on a free
    port."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world_size != 1:
            raise ValueError("a process group of more than one rank needs init_method or "
                             "torchrun's MASTER_ADDR/MASTER_PORT")
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """The running process group's world as a ``(world, 1)`` mesh over
    ``data, model``, as JAX's ``(n, 1)`` over the host's devices. Starts a
    group (``init_process_group``) if none runs."""
    init_process_group(device)
    dev_type = torch.device(device).type
    return init_device_mesh(dev_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
