"""End-to-end training, the twin of ``repro/launch/train.py``.

Wires together the prefetched synthetic data, the train step (forward with
remat, chunked loss, AdamW with an f32 master copy), the async checkpoints
(the paper's flusher queues) and restart/resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --preset smoke --steps 50 --batch 8 --seq 128 --ckpt-dir build/ckpt

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

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data import Prefetcher, SyntheticLM, to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw_init
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


def train(cfg: ModelConfig, args: argparse.Namespace) -> list[float]:
    """Train ``cfg`` as ``args`` (``parser()``'s flags) say; the ce losses."""
    device = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps,
                              microbatches=args.microbatches)

    ckpt = None
    start_step = 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if args.resume and ckpt.latest_step() is not None:
            start_step, (params, opt) = ckpt.restore((params, opt))
            start_step += 1
            print(f"resumed from step {start_step - 1}")

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)
    it = Prefetcher(({"step": s, **data.batch(s)} for s in range(start_step, args.steps)),
                    depth=4)
    t0 = time.time()
    losses = []
    try:
        for raw in it:
            s = raw.pop("step")
            raw = modality_stubs(raw, cfg, args.batch, args.seq, args.seed, s)
            params, opt, metrics = step_fn(params, opt, to_device(raw, device))
            losses.append(float(metrics["ce"]))
            if ckpt and (s + 1) % args.ckpt_every == 0:
                ckpt.save_async(s, (params, opt))
            if (s + 1) % args.log_every == 0 or s == args.steps - 1:
                dt = time.time() - t0
                tok_s = (s - start_step + 1) * args.batch * args.seq / max(dt, 1e-9)
                print(f"step {s + 1:5d}  ce={losses[-1]:.4f}  "
                      f"gnorm={float(metrics['grad_norm']):.3f}  "
                      f"lr={float(metrics['lr']):.2e}  tok/s={tok_s:,.0f}")
        if ckpt:
            ckpt.save_async(args.steps - 1, (params, opt))
            ckpt.drain()
            print("ckpt stats:", ckpt.stats)
    finally:
        it.close()
        if ckpt:
            ckpt.close()
    if len(losses) > 10:
        a, b = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        print(f"loss first5={a:.4f} last5={b:.4f} ({'DOWN' if b < a else 'UP'})")
    return losses


def main(argv=None) -> list[float]:
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = reduced(cfg, max_seq=max(args.seq, 128))
    return train(cfg, args)


if __name__ == "__main__":
    main()
