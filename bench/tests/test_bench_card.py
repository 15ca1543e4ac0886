"""On a card: the command runs a short window of each cell and prints a
correct result line. Skips without a CUDA device (run on the card with
``python -m pytest -m cuda bench/tests``)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_small import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_on_the_card(card, name):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "5", "--trace", "0"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
