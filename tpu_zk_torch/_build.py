"""Builds the port's native code at first use, into ``build/tpu_zk_torch/``.

* :func:`kernel_library` -- the CUDA kernels of ``csrc/`` (nvcc, ``sm_90a``),
  a plain-C shared library loaded with ctypes.
* :func:`keccak_library` -- the host Keccak sponge of ``native/keccak.cpp``
  (g++, without ``-march=native`` so the library runs on any x86-64 host).

Each library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and a finished build is reused.  Builds write to a
temporary file and rename it into place, so concurrent processes never load
a half-written library.  Nothing is built when the package is imported, and
a build that fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_ROOT = _PKG.parent
BUILD_DIR = _ROOT / "build" / "tpu_zk_torch"
CSRC = _PKG / "csrc"
KECCAK_SRC = _ROOT / "native" / "keccak.cpp"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]


def _compile(compiler: str, flags: list[str], sources: list[Path], headers: list[Path], stem: str) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(sources + headers):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [compiler, *flags, "-o", tmp, *map(str, sources)]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            raise RuntimeError(f"build of {stem} failed: {' '.join(cmd)}\n{done.stdout}{done.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return found


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the CUDA kernels."""
    so = _compile(_nvcc(), NVCC_FLAGS, sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh")), "tzk_kernels")
    lib = ctypes.CDLL(str(so))
    ptr, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    lib.tzk_mont_mul.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr, u32, ptr]
    lib.tzk_mont_mul.restype = ctypes.c_int
    lib.tzk_addsub.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, ptr, ptr]
    lib.tzk_addsub.restype = ctypes.c_int
    lib.tzk_fold.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i32, ptr, u32, ptr]
    lib.tzk_fold.restype = ctypes.c_int
    return lib


@functools.cache
def keccak_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the host Keccak sponge."""
    so = _compile("g++", GXX_FLAGS, [KECCAK_SRC], [], "keccak")
    lib = ctypes.CDLL(str(so))
    lib.keccak_absorb_blocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.keccak_absorb_blocks.restype = None
    return lib
