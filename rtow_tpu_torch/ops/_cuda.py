"""Builds the CUDA sources under ``rtow_tpu_torch/csrc/`` with nvcc into
shared libraries with a plain C interface, and loads them with ctypes.

A library is built at first use into ``rtow_tpu_torch/_build/`` (listed
in ``.gitignore``), from the repository's sources only.  Its file name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is never served by a stale build.  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: Hopper (sm_90a).  -fmad=false and no --use_fast_math: the kernel
#: rounds every float32 operation as the plain PyTorch version does, so
#: the two differ only by the math library's last bits.  -Xptxas -v
#: reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    #: nvcc's wall time in this process; 0.0 when an existing build
    #: was reused.
    seconds: float
    #: nvcc's diagnostics (the ptxas register/spill report).
    log: str


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


_BUILT: dict = {}


def _target(name: str) -> Path:
    """The library path of ``csrc/<name>.cu``: named by a hash of the
    source, every header of ``csrc/`` and the flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build_all(names) -> dict:
    """Compile ``csrc/<name>.cu`` for every name that has no build of the
    same sources and flags yet, one nvcc process per source, all started
    together.  Returns {name: Build}."""
    started = {}
    for name in names:
        if name in _BUILT:
            continue
        out = _target(name)
        if out.exists():
            _BUILT[name] = Build(out, 0.0, "")
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src = CSRC / f"{name}.cu"
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started[name] = (src, out, tmp, proc, time.perf_counter())
    failed = []
    for name, (src, out, tmp, proc, t0) in started.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        _BUILT[name] = Build(out, seconds, stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _BUILT[name] for name in names}


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a build of the same sources and
    flags exists."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if needed, with its
    ``rtow_cuda_error_string`` declared."""
    lib = ctypes.CDLL(str(build(name).path))
    lib.rtow_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rtow_cuda_error_string.restype = ctypes.c_char_p
    return lib


def device_args(t) -> tuple:
    """(device index, current stream handle) of a CUDA tensor: the last
    two arguments of every launcher."""
    import torch

    index = (t.device.index if t.device.index is not None
             else torch.cuda.current_device())
    return index, torch.cuda.current_stream(t.device).cuda_stream


def check_launch(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launcher of ``lib`` returned a CUDA error."""
    if err:
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {err} "
            f"({lib.rtow_cuda_error_string(err).decode()})")
