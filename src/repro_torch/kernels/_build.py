"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface, so it compiles with ``nvcc``
alone into a shared library that ``ctypes`` loads: no PyTorch headers, no
pybind, no ninja, a build of seconds. The library goes to ``build/torch_ext/``
at the root of the checkout, named by a hash of the source, the flags, the
nvcc binary and the torch version, so an edit rebuilds and an unchanged tree
reuses the library; nvcc's report (registers, spills) is kept beside it.
A file lock keeps concurrent builds apart.

Nothing here runs at import: the first call of a kernel on a CUDA tensor
builds it. A failed build raises. ``bind``, ``check_tensors``,
``raise_on_error`` and ``kernel_constants`` are what the kernels' wrappers
share.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}     # name -> nvcc output of the library's build


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are compiled at first use")
    return found


def _lib_path(name: str, nvcc: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(b"\0".join([
        src, " ".join(NVCC_FLAGS).encode(), nvcc.encode(),
        torch.__version__.encode()])).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    if name in _loaded:
        return _loaded[name]
    nvcc = nvcc_path()
    lib = _lib_path(name, nvcc)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        log = lib.with_suffix(".log")
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_logs[name] = res.stdout + res.stderr
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {res.returncode}):\n{build_logs[name]}")
            log.write_text(build_logs[name])
            os.replace(tmp, lib)
        elif log.exists():
            build_logs[name] = log.read_text()
    _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]


def bind(name: str, symbol: str, argtypes: list):
    """Build and load ``csrc/<name>.cu``; its C entry point ``symbol``, which
    returns a cudaError_t as an int."""
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn


def raise_on_error(name: str, err: int) -> None:
    """Raise for the cudaError_t a launch of ``name`` returned (0 is success):
    a refused launch never runs, and a later synchronize would not say so."""
    if err:
        msg = _loaded[name].repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def check_tensors(name: str, align: int = 1, **tensors: torch.Tensor) -> None:
    """What every kernel takes: CUDA tensors on one device, contiguous, and
    ``align``-byte aligned for the kernel's vector loads."""
    device = next(iter(tensors.values())).device
    for what, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} kernel: {what} is not on a CUDA device")
        if t.device != device:
            raise ValueError(f"{name} kernel: {what} on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {what} is not contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} kernel: {what} is not {align}-byte aligned")


def kernel_constants(name: str, *names: str) -> tuple[int, ...]:
    """Integers of ``csrc/<name>.cu``'s ``constexpr int`` lines, so Python
    that plans or mirrors a kernel reads the kernel's own geometry (nothing
    builds)."""
    src = (CSRC / f"{name}.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1)) for n in names)
