"""The port stands alone: no file of ``src/repro_torch`` nor ``chip_smoke.py``
imports JAX or the JAX package, and importing the kernels on a machine
without ``nvcc`` builds nothing."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _banned(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_kernel_modules_import_and_run_on_cpu_without_nvcc(tmp_path):
    code = (
        "import sys, torch\n"
        "import repro_torch.kernels.ops as ops\n"
        "from repro_torch.kernels import _build, paged_attention as pa\n"
        "q = torch.zeros(1, 2, 16); kp = torch.zeros(2, 4, 1, 16)\n"
        "out = ops.paged_attention(q, kp, kp, torch.zeros(1, 2, dtype=torch.int32),\n"
        "                          torch.ones(1, dtype=torch.int32))\n"
        "assert out.shape == (1, 2, 16)\n"
        "assert not _build._loaded and pa._fn is None and pa.paged_attention.launches == 0\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "try:\n"
        "    _build.nvcc_path()\n"
        "except RuntimeError:\n"
        "    print('no-nvcc')\n")
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)                  # no nvcc on this PATH
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    if not Path("/usr/local/cuda/bin/nvcc").exists():
        assert "no-nvcc" in res.stdout
