"""Kernel build: compiles `csrc/<name>.cu` with nvcc into a shared
library with a plain C interface, loaded through ctypes by the wrappers.

The library lands in `mitsuba_tpu_torch/_build/` (git-ignored), named by a
hash of the source and flags, so an edited source is rebuilt and an
unchanged one is built once. Only sources in the repository are compiled.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# sm_90a: Hopper. --fmad=false keeps a*b+c as two roundings, so the kernels
# round like their plain PyTorch versions; no fast math, so 1.0f/x is IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of nvcc in the CUDA toolkit torch finds ($CUDA_HOME, then the
    nvcc on PATH, then the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same source and flags
    exists. Returns the library's path; raises with nvcc's output when the
    build fails."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent build never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {src.name}:\n"
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib
