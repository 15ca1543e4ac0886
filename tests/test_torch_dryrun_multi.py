"""Every arch x shape cell of the port's dry run on the two-pod production
mesh (2, 16, 16), a fake process group of 512 ranks, on the CPU route:
``test_torch_dryrun.py``'s check (its helpers, loaded by path), split from
it to keep each file's run short."""
import importlib.util
from pathlib import Path

import pytest
import torch.distributed as dist

_spec = importlib.util.spec_from_file_location(
    "torch_dryrun_helpers", Path(__file__).resolve().parent / "test_torch_dryrun.py")
D = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(D)


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", D.CELLS)
def test_reduced_cell_runs_on_multi_mesh(arch, shape, tmp_path):
    D.check_cell(arch, shape, "multi", tmp_path)
