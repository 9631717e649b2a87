"""Builds the port's native code at first use, into ``build/tpu_zk_torch/``.

* :func:`kernel_library` -- the CUDA kernels of ``csrc/`` (nvcc, ``sm_90a``):
  one plain-C shared library per ``.cu`` source, all compiled at the same
  time, loaded with ctypes behind one namespace.
* :func:`keccak_library` -- the host Keccak sponge of ``native/keccak.cpp``
  (g++, without ``-march=native`` so the library runs on any x86-64 host).
* :func:`pairing_library` -- the host pairing engine of ``native/pairing.cpp``
  (g++).

Each library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and a finished build is reused.  Builds write to a
temporary file and rename it into place, so concurrent processes never load
a half-written library.  Nothing is built when the package is imported, and
a build that fails raises.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import types
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_ROOT = _PKG.parent
BUILD_DIR = _ROOT / "build" / "tpu_zk_torch"
CSRC = _PKG / "csrc"
KECCAK_SRC = _ROOT / "native" / "keccak.cpp"
PAIRING_SRC = _ROOT / "native" / "pairing.cpp"

# -Xptxas -v: each kernel's registers and spills go to the build's log, which resource_usage() reads
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
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
        so.with_suffix(".log").write_text(done.stdout + done.stderr)
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


# exported function -> ctypes argument types; every one returns a cudaError_t
_PTR, _I64, _I32, _U32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
KERNEL_ARGTYPES = {
    "tzk_mont_mul": [_PTR, _PTR, _PTR, _I64, _I32, _I32, _PTR, _U32, _PTR],
    "tzk_addsub": [_PTR, _PTR, _PTR, _I64, _I32, _I32, _I32, _PTR, _PTR],
    "tzk_fold": [_PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I32, _PTR, _U32, _PTR],
    # px, py, pz, row stride, entries (may be null), units, one, out, units count, L, 3b, p32, n0inv, stream
    "tzk_msm_buckets": [_PTR, _PTR, _PTR, _I64, _PTR, _PTR, _PTR, _PTR, _I64, _I32, _I32, _PTR, _U32, _PTR],
    # buckets, out, W, B, m, L, 3b, p32, n0inv, stream
    "tzk_msm_bucket_reduce": [_PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _PTR, _U32, _PTR],
    # x, tws, pre, scale, dst, out, A, log_m, C, L, p32, n0inv, stream (csrc/ntt.cu); pre, scale, dst may be null
    "tzk_ntt_pass": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I32, _I64, _I32, _PTR, _U32, _PTR],
    # data, out, n rows, w bytes a row, stream (csrc/keccak.cu)
    "tzk_keccak_rows": [_PTR, _PTR, _I64, _I32, _PTR],
    # out, blocks (of 256 threads), iters, a, b, stream: blocks * 256 * 8 * iters multiply-adds (csrc/probe.cu)
    "tzk_imad_probe": [_PTR, _I32, _I32, _U32, _U32, _PTR],
    # out, blocks, iters, a, stream: as many wide (32 x 32 + 64 -> 64 bit) multiply-adds, the CIOS instruction
    "tzk_wide_mad_probe": [_PTR, _I32, _I32, _U32, _PTR],
    # out, blocks, iters, s, k, stream: blocks * 256 * 16 * iters 32-bit funnel shifts and logic ops
    "tzk_logic_probe": [_PTR, _I32, _I32, _U32, _U32, _PTR],
}


@functools.cache
def kernel_library() -> types.SimpleNamespace:
    """Build (once per source hash) and load the CUDA kernels: every
    exported function of every ``csrc/*.cu`` as an attribute."""
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, side by side
        paths = list(pool.map(lambda src: _compile(nvcc, NVCC_FLAGS, [src], headers, f"tzk_{src.stem}"), sources))
    lib = types.SimpleNamespace()
    libraries = [ctypes.CDLL(str(so)) for so in paths]
    for name, argtypes in KERNEL_ARGTYPES.items():
        owners = [dll for dll in libraries if hasattr(dll, name)]
        if len(owners) != 1:
            raise RuntimeError(f"{name}: exported by {len(owners)} of the kernel libraries, expected 1")
        fn = getattr(owners[0], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        setattr(lib, name, fn)
    return lib


def _kernel_name(mangled: str) -> str:
    """``_ZN3tzk11fold_kernelILi12EEEv...`` -> ``fold_kernel<12>``."""
    head = re.match(r"_ZN3tzk(\d+)", mangled)
    if not head:
        return mangled
    name_end = head.end() + int(head.group(1))
    name = mangled[head.end():name_end]
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[name_end:])
    return f"{name}<{','.join(re.findall(r'L[a-z](\d+)E', args.group(1)))}>" if args else name


def resource_usage() -> dict[str, dict[str, int]]:
    """Registers and spill bytes of every CUDA kernel, as ptxas reported them
    when the libraries now in ``build/`` were built: ``{"fold_kernel<8>":
    {"registers": 74, "spill_stores": 0, "spill_loads": 0}, ...}``."""
    kernel_library()
    out = {}
    pattern = re.compile(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill loads"
                         r".*?Used (\d+) registers", re.S)
    for log in sorted(BUILD_DIR.glob("tzk_*.log")):
        for mangled, stores, loads, registers in pattern.findall(log.read_text()):
            out[_kernel_name(mangled)] = {"registers": int(registers), "spill_stores": int(stores),
                                          "spill_loads": int(loads)}
    return out


@functools.cache
def keccak_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the host Keccak sponge."""
    so = _compile("g++", GXX_FLAGS, [KECCAK_SRC], [], "keccak")
    lib = ctypes.CDLL(str(so))
    lib.keccak_absorb_blocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.keccak_absorb_blocks.restype = None
    # messages or leaves, count, bytes each, out: [count, 32] digests / every tree level, [2 count - 1, 32]
    for fn in (lib.keccak256_many, lib.merkle_build):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p]
        fn.restype = None
    return lib


@functools.cache
def pairing_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the host pairing engine."""
    so = _compile("g++", ["-O3", "-shared", "-fPIC"], [PAIRING_SRC], [], "pairing")
    lib = ctypes.CDLL(str(so))
    lib.pairing_product_is_one.restype = ctypes.c_int
    lib.pairing_product_is_one.argtypes = [
        ctypes.c_void_p,  # CurveBlob* (curves/pairing_native.py)
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    return lib
