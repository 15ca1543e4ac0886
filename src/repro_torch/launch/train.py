"""End-to-end training, the twin of ``repro/launch/train.py``.

Wires together the prefetched synthetic data, the mesh and the sharding
rules (params and optimizer state placed by ``param_specs``, the batch by
``data_spec``), the train step (forward with remat, chunked loss, AdamW
with an f32 master copy), the async checkpoints (the paper's flusher
queues) and restart/resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --preset smoke --steps 50 --batch 8 --seq 128 --ckpt-dir build/ckpt

It runs at world 1 by default (a process group of one over a local store),
and at world N under ``torchrun --nproc-per-node N`` (nccl on cards, gloo
on the CPU) or in processes whose caller has started the group: the mesh is
``(world, 1)`` over ``data, model`` (``make_host_mesh``), and rank 0 prints.

``--preset smoke`` trains the reduced config (CPU-sized), ``full`` the
published one (tinyllama-1.1b: 1.1B parameters in bf16 with an f32 master
copy, on one H100). Weights are random, drawn on the device from
``--seed``. ``--device`` defaults to cuda and raises if there is no card.
whisper-tiny and qwen2-vl-72b get stub inputs (random encoder frames and
patch embeddings, M-RoPE positions), as in ``repro/launch/train.py``. With
``--resume`` the run continues at the step after the last committed
checkpoint.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data import Prefetcher, SyntheticLM, make_global_batch
from repro_torch.distributed import data_spec, distribute_tree, param_specs
from repro_torch.distributed.sharding import P, replicate
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.serving.engine import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation slices (activation stash / N)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def modality_stubs(raw: dict, cfg: ModelConfig, batch: int, seq: int, seed: int,
                   step: int) -> dict:
    """Precomputed front-end stand-ins (the front ends are stubs): whisper's
    encoder frames, qwen2-vl's patch embeddings and M-RoPE positions."""
    rng_np = np.random.default_rng((seed << 16) ^ step)
    if cfg.encoder_layers:
        raw["enc_frames"] = rng_np.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vis_tokens:
        raw["vis_embeds"] = rng_np.normal(
            size=(batch, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
        raw["positions"] = np.broadcast_to(
            np.arange(seq, dtype=np.int32)[None, None, :], (batch, 3, seq)).copy()
    return raw


def opt_specs(opt: AdamWState, p_specs) -> AdamWState:
    """The optimizer state's specs: m, v and master by the params', step
    replicated."""
    return AdamWState(step=P(), m=p_specs, v=p_specs,
                      master=p_specs if opt.master is not None else None)


def train(cfg: ModelConfig, args: argparse.Namespace) -> list[float]:
    """Train ``cfg`` as ``args`` (``parser()``'s flags) say; the ce losses.
    Every rank draws the same weights and batches from ``--seed`` and keeps
    its own shards of them. A process group it starts itself (world 1) it
    also ends."""
    device = resolve_device(args.device)
    own_group = not dist.is_initialized()
    mesh = make_host_mesh(device)
    main_rank = dist.get_rank() == 0
    log = print if main_rank else (lambda *a, **k: None)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    p_specs = param_specs(params, mesh)
    params = distribute_tree(params, p_specs, mesh)
    opt = adamw_init(params)
    opt = opt._replace(step=replicate(opt.step, mesh))
    step_fn = make_train_step(cfg, mesh, peak_lr=args.lr, total_steps=args.steps,
                              microbatches=args.microbatches)

    ckpt = None
    start_step = 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if args.resume and ckpt.latest_step() is not None:
            start_step, (params, opt) = ckpt.restore(
                (params, opt), shardings=(p_specs, opt_specs(opt, p_specs)), mesh=mesh)
            start_step += 1
            log(f"resumed from step {start_step - 1}")

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)
    dspec = data_spec(mesh, args.batch)
    it = Prefetcher(({"step": s, **data.batch(s)} for s in range(start_step, args.steps)),
                    depth=4)
    t0 = time.time()
    losses = []
    try:
        for raw in it:
            s = raw.pop("step")
            raw = modality_stubs(raw, cfg, args.batch, args.seq, args.seed, s)
            batch = make_global_batch(raw, mesh, dspec, device)
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(float(metrics["ce"]))
            if ckpt and (s + 1) % args.ckpt_every == 0:
                ckpt.save_async(s, (params, opt))
            if (s + 1) % args.log_every == 0 or s == args.steps - 1:
                dt = time.time() - t0
                tok_s = (s - start_step + 1) * args.batch * args.seq / max(dt, 1e-9)
                log(f"step {s + 1:5d}  ce={losses[-1]:.4f}  "
                    f"gnorm={float(metrics['grad_norm']):.3f}  "
                    f"lr={float(metrics['lr']):.2e}  tok/s={tok_s:,.0f}")
        if ckpt:
            ckpt.save_async(args.steps - 1, (params, opt))
            ckpt.drain()
            log("ckpt stats:", ckpt.stats)
    finally:
        it.close()
        if ckpt:
            ckpt.close()
        if own_group:
            dist.destroy_process_group()
    if len(losses) > 10:
        a, b = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"loss first5={a:.4f} last5={b:.4f} ({'DOWN' if b < a else 'UP'})")
    return losses


def main(argv=None) -> list[float]:
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = reduced(cfg, max_seq=max(args.seq, 128))
    return train(cfg, args)


if __name__ == "__main__":
    main()
