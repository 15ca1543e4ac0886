"""Train a ~100M-parameter TinyLlama-family model for a few hundred steps
with the whole stack (prefetched synthetic data, the train step, async
flusher-backed checkpoints), the twin of ``examples/train_100m.py``.

  PYTHONPATH=src python -m repro_torch.launch.train_100m [--steps 300] [--device cuda]

~100M params: 12L d_model=768 12H kv=4 d_ff=2048 vocab=32000, float32. The
config goes to ``train.train`` directly.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch import train as T

CFG_100M = dataclasses.replace(
    get_config("tinyllama-1.1b"),
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
    vocab=32000, head_dim=64, dtype="float32", max_seq=512)


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="build/train_100m_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"~{CFG_100M.param_count() / 1e6:.0f}M parameters")
    targs = T.parser().parse_args([
        "--steps", str(args.steps), "--batch", str(args.batch), "--seq", str(args.seq),
        "--lr", "3e-4", "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--device", args.device])
    return T.train(CFG_100M, targs)


if __name__ == "__main__":
    main()
