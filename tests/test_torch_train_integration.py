"""The port's ``launch.train`` end to end on the CPU (loss down, checkpoint and
resume, the special families): twins of tests/test_train_integration.py,
whose JAX ``launch/train.main`` fails under this jax version, at the same small sizes."""
import numpy as np
import pytest

from repro_torch.launch import train_100m
from repro_torch.launch.train import main as train_main


def test_train_loss_decreases(tmp_path):
    losses = train_main([
        "--arch", "tinyllama-1.1b", "--preset", "smoke", "--steps", "30",
        "--batch", "8", "--seq", "64", "--lr", "3e-3",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "10", "--device", "cpu"])
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_train_resume_continues(tmp_path):
    """A run to step 8 commits checkpoints at steps 3 and 7; the resumed run
    starts at step 8, the last committed step + 1."""
    args = ["--arch", "granite-moe-1b-a400m", "--preset", "smoke", "--batch", "4",
            "--seq", "32", "--device", "cpu"]
    train_main(args + ["--steps", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    losses = train_main(args + ["--steps", "12", "--ckpt-dir", str(tmp_path), "--resume"])
    assert len(losses) == 4            # resumed at step 8, ran 8..11
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ["mamba2-780m", "whisper-tiny", "qwen2-vl-72b"])
def test_train_special_families(arch, tmp_path):
    losses = train_main(["--arch", arch, "--preset", "smoke", "--steps", "6",
                         "--batch", "4", "--seq", "64", "--device", "cpu"])
    assert len(losses) == 6 and all(np.isfinite(l) for l in losses)


def test_train_100m_twin_takes_its_config(tmp_path):
    """The examples/train_100m.py twin trains its 12-layer config, passed to
    ``train.train`` directly (2 steps at a short sequence here)."""
    losses = train_100m.main(["--steps", "2", "--batch", "2", "--seq", "16",
                              "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert (tmp_path / "manifest-1.json").exists()
    assert train_100m.CFG_100M.n_layers == 12 and train_100m.CFG_100M.d_model == 768
