"""Shape-only dry run of every (arch x shape) cell on the production meshes,
with the per-device roofline terms counted from the program itself; the
port's twin of ``repro/launch/dryrun.py``.

Nothing is allocated: the inputs are fake tensors (``launch/specs.py``),
the process group is PyTorch's fake backend (256 ranks for ``single``, a
(16, 16) ``data, model`` mesh; 512 for ``multi``, (2, 16, 16) ``pod, data,
model``), and this process plays rank 0. The port's own step runs on it,
as a user calls it (``launch/steps.make_train_step``, ``make_prefill_step``,
``make_decode_step``): parameters placed by ``param_specs`` (``fsdp=False``
for decode, as JAX), the batch by ``data_spec``, the optimizer state by the
parameters' placements, the decode cache by ``cache_specs``, as JAX's
(``init_decode_cache(mesh=)``: the rows over the data axes and the KV
sequence over ``model``, the Mamba2 state by rows and heads). A cell that runs
to its end proves that the placements compose at production scale (no
placement DTensor cannot propagate, every collective issued); ``launch/
cost.py`` counts what the step runs on rank 0's shards.

The JSON keeps JAX's keys where they mean the same thing
(``flops_per_device``, ``bytes_per_device``, ``collectives``,
``roofline``, ``model_flops_per_device``, ``useful_flop_ratio``).
``memory`` is per-device argument bytes (the local shards of the step's
inputs) and the peak of live fake bytes the step allocated on top of them.
``trace_s`` (the step's run on fake tensors) replaces ``lower_s`` and
``compile_s``. JAX's ``loops`` (scan trip counts its HLO parser multiplies
by) has no counterpart: the eager step runs every layer and every remat
recompute, each counted as it runs.

The roofline terms are derived from published peaks, not measured: an H100
SXM at its 700 W limit (NVIDIA's data sheet, dense rates). Collectives over
the ``pod`` axis cross nodes at the network rate, the others run over
NVLink.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --device cpu

``--device cuda`` (the default) traces the card's route (the kernels as
operators, fake tensors on the card) and needs a CUDA build of PyTorch;
``--device cpu`` the CPU route (plain attention).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.distributed.sharding import (PartitionSpec, data_spec, distribute_tree,
                                              param_specs, placements, replicate)
from repro_torch.launch import specs as S
from repro_torch.launch.cost import CostMode
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves

# H100 SXM, per card, NVIDIA's data sheet (dense, no sparsity), at the 700 W
# power limit those rates assume
PEAK_FLOPS = 989e12        # bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12           # bytes/s
NVLINK_BW = 450e9          # bytes/s each way (900 GB/s both ways), to the cards of a node
NETWORK_BW = 50e9          # bytes/s a card across nodes: eight 400 Gb/s NICs per 8-card node
POWER_LIMIT_W = 700
DEFAULT_OUT = Path("build/dryrun_torch")


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (no
    communication: every collective returns at once). Any group already
    running is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def production_mesh(kind: str, device: str):
    """The ``single`` or ``multi`` production mesh on a fake group of its
    size (``start_fake_group``)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[kind == "multi"]
    start_fake_group(math.prod(shape))
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axes)


def _place_batch(batch: dict, mesh, rows: int) -> dict:
    """dim 0 over ``data_spec``'s first entry, the rest replicated, as the
    train driver's ``make_global_batch``."""
    spec = data_spec(mesh, rows)
    pl = placements(PartitionSpec(spec[0] if len(spec) else None), mesh)
    return {k: distribute_tensor(t, mesh, pl, src_data_rank=None) for k, t in batch.items()}


def build_cell(arch: str, shape_name: str, mesh, *, remat: bool = True,
               cfg_overrides: dict | None = None, microbatches: int = 1,
               device: str = "cuda", mode: FakeTensorMode | None = None):
    """``(step, args, cfg, shape)``: the cell's step function and its fake
    inputs, placed on ``mesh`` (None: unsharded, one device). Build and
    call under ``mode``. ``shape_name`` names a ``SHAPES`` cell, or is a
    ``ShapeConfig`` of its own."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mode = mode or FakeTensorMode()
    params = S.params_specs(cfg, device, mode)
    b = shape.global_batch
    with mode:
        if mesh is not None:
            params = distribute_tree(params, param_specs(params, mesh,
                                                         fsdp=shape.mode != "decode"), mesh)
        if shape.mode == "train":
            batch = S.train_batch_specs(cfg, shape, device, mode)
            opt = adamw_init(params)
            if mesh is not None:
                batch = _place_batch(batch, mesh, b)
                opt = opt._replace(step=replicate(opt.step, mesh))
            step = make_train_step(cfg, mesh, remat=remat, microbatches=microbatches)
            return step, (params, opt, batch), cfg, shape
        if shape.mode == "prefill":
            batch = S.prefill_batch_specs(cfg, shape, device, mode)
            if mesh is not None:
                batch = _place_batch(batch, mesh, b)
            return make_prefill_step(cfg, shape.seq_len, mesh), (params, batch), cfg, shape
        batch = S.decode_batch_specs(cfg, shape, device, mode)
        cache = S.cache_specs_struct(cfg, b, shape.seq_len, device, mode, mesh=mesh)
        if mesh is not None:
            batch = _place_batch(batch, mesh, b)
        return make_decode_step(cfg, mesh), (params, cache, batch), cfg, shape


def local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` that this rank holds (a DTensor's
    local shard)."""
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


def model_flops(cfg, shape) -> float:
    """JAX's useful-FLOP yardstick: 6 N tokens to train, 2 N tokens to
    prefill or decode, N the active parameters."""
    tokens = shape.global_batch * (1 if shape.mode == "decode" else shape.seq_len)
    return (6 if shape.mode == "train" else 2) * cfg.active_param_count() * tokens


def _axis_of_groups(mesh) -> dict:
    return {mesh.get_group(name).group_name: name for name in mesh.mesh_dim_names}


def roofline(flops: float, memory_bytes: float, coll_by_axis: dict) -> dict:
    """Derived H100 terms (seconds): FLOPs over the bf16 peak, bytes over
    HBM, collective payloads over NVLink, or the network for ``pod``."""
    collective_s = sum(b / (NETWORK_BW if axis == "pod" else NVLINK_BW)
                       for axis, b in coll_by_axis.items())
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": memory_bytes / HBM_BW,
             "collective_s": collective_s}
    return {**terms, "bottleneck": max(terms, key=terms.get)[:-2],
            "derived_from": {"peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                             "nvlink_bytes_per_s": NVLINK_BW,
                             "network_bytes_per_s": NETWORK_BW,
                             "power_limit_w": POWER_LIMIT_W}}


def count_cell(arch: str, shape_name: str, mesh, *, device: str = "cuda",
               breakdown: bool = False, **build) -> dict:
    """Builds the cell on ``mesh`` (a ``DeviceMesh`` on a running group, or
    None) and runs its step once under a ``CostMode``: the counter, the
    argument bytes, ``cfg``, ``shape`` and the seconds it took."""
    mode = FakeTensorMode()
    t0 = time.perf_counter()
    step, args, cfg, shape = build_cell(arch, shape_name, mesh, device=device, mode=mode,
                                        **build)
    counter = CostMode(breakdown=breakdown)
    t1 = time.perf_counter()
    with mode, counter:
        step(*args)
    return {"counter": counter, "argument_bytes": local_bytes(args), "cfg": cfg,
            "shape": shape, "setup_s": t1 - t0, "trace_s": time.perf_counter() - t1}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, device: str = "cuda",
             out_dir: Path | None = None, remat: bool = True, verbose: bool = True,
             cfg_overrides: dict | None = None, breakdown: bool = False) -> dict:
    """One cell (a ``SHAPES`` name or a ``ShapeConfig``) on the ``single``
    or ``multi`` mesh: its JSON record, written to ``out_dir`` if given.
    The fake group is destroyed at the end."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the card's route (device cuda) needs a CUDA build of PyTorch; "
                           "device cpu traces the CPU route")
    try:
        mesh = production_mesh(mesh_kind, device)
        chips = mesh.size()
        cell = count_cell(arch, shape_name, mesh, device=device, breakdown=breakdown,
                          remat=remat, cfg_overrides=cfg_overrides)
        groups = _axis_of_groups(mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    counter, cfg, shape = cell["counter"], cell["cfg"], cell["shape"]
    shape_name = shape.name
    arg_bytes, trace_s = cell["argument_bytes"], cell["trace_s"]
    tot = counter.totals()
    by_axis: dict = {}
    for group, b in counter.collective_by_group.items():
        axis = groups.get(group, "pod" if mesh_kind == "multi" else "world")
        by_axis[axis] = by_axis.get(axis, 0) + b
    flops, mem = tot["flops"], tot["memory_bytes"]
    model_per_dev = model_flops(cfg, shape) / chips
    res = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": chips,
        "mode": shape.mode, "tag": "", "overrides": cfg_overrides or {}, "device": device,
        "torch": torch.__version__, "setup_s": cell["setup_s"], "trace_s": trace_s,
        "flops_per_device": flops, "bytes_per_device": mem,
        "collectives": {"bytes": tot["collective_bytes"], "counts": tot["collective_counts"],
                        "total_bytes": tot["collective_total"], "by_axis": by_axis},
        "kernel_calls": tot["kernel_calls"],
        "memory": {"argument_bytes": arg_bytes, "peak_live_bytes": tot["peak_live_bytes"],
                   "peak_bytes": arg_bytes + tot["peak_live_bytes"]},
        "roofline": roofline(flops, mem, by_axis),
        "model_flops_per_device": model_per_dev,
        "useful_flop_ratio": model_per_dev / flops if flops else None,
    }
    if breakdown:
        res["breakdown"] = {k: tot[k] for k in ("by_op", "by_path", "collectives_by_path")}
    if verbose:
        r = res["roofline"]
        print(f"[{arch} x {shape_name} x {mesh_kind}] chips={chips} device={device} "
              f"trace={trace_s:.1f}s flops/dev={flops:.3e} bytes/dev={mem:.3e} "
              f"coll/dev={tot['collective_total']:.3e}B | derived H100: compute="
              f"{r['compute_s'] * 1e3:.2f}ms memory={r['memory_s'] * 1e3:.2f}ms "
              f"collective={r['collective_s'] * 1e3:.2f}ms -> {r['bottleneck']} | useful="
              f"{res['useful_flop_ratio'] and round(res['useful_flop_ratio'], 3)} | args="
              f"{arg_bytes / 2 ** 30:.2f} GiB/dev peak={res['memory']['peak_bytes'] / 2 ** 30:.2f}"
              f" GiB/dev", flush=True)
    if out_dir:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}_{shape_name}_{mesh_kind}.json").write_text(
            json.dumps({k: v for k, v in res.items() if k != "breakdown"}, indent=1,
                       default=float))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda traces the card's route and needs a CUDA build of PyTorch; "
                 "--device cpu traces the CPU route")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s, m) for a in ARCH_IDS for s in cells(a) for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape, m) for m in meshes]
    failures = []
    for arch, shp, m in todo:
        try:
            run_cell(arch, shp, m, device=args.device, out_dir=Path(args.out),
                     remat=not args.no_remat)
        except Exception as e:       # one cell's failure is reported, the sweep goes on
            failures.append((arch, shp, m, repr(e)[:300]))
            print(f"FAIL [{arch} x {shp} x {m}]: {e!r}"[:500], flush=True)
    print(f"\n{len(todo) - len(failures)}/{len(todo)} cells passed")
    for f in failures:
        print("  FAIL", *f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
