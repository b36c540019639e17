"""Build the port's native code at first use, into ``_build/`` beside this
file.

Two toolchains, both producing shared libraries with a plain C interface that
:mod:`ctypes` loads:

* ``g++`` for the host symbolic kernels (the JAX package's
  ``elemental_tpu/native/symbolic.cpp``, read in place, not copied);
* ``nvcc`` for the CUDA kernels under ``csrc/``, compiled for Hopper
  (``sm_90a``).

A library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  Each build writes to a
temporary file and renames it into place, so concurrent test workers that
build the same library do not read a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import List, Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _compile(compiler: str, flags: List[str], name: str,
             sources: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join([compiler] + flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, *sources],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} with {compiler} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_host_library(name: str, sources: Sequence[str]) -> str:
    """Compile C++ ``sources`` with ``g++`` into ``_build/``; returns the
    library's path."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's symbolic analysis "
                           "needs it to build its native kernels")
    return _compile(gxx, GXX_FLAGS, name, sources)


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH")
    return nvcc


def build_cuda_library(name: str, sources: Sequence[str]) -> str:
    """Compile CUDA ``sources`` (paths under ``csrc/``) with ``nvcc`` for
    sm_90a into ``_build/``; returns the library's path."""
    return _compile(nvcc_path(), NVCC_FLAGS, name, sources)
