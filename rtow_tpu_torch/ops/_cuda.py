"""Builds the CUDA sources under ``rtow_tpu_torch/csrc/`` with nvcc into
shared libraries with a plain C interface, and loads them with ctypes.

A library is built at first use into ``rtow_tpu_torch/_build/`` (listed
in ``.gitignore``), from the repository's sources only.  Its file name
carries a hash of the source and the flags, so an edited source is never
served by a stale build.  Nothing here runs at import time.
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


@functools.lru_cache(maxsize=None)
def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a build of the same source and
    flags exists."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return Build(out, seconds, proc.stderr)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build(name).path))
