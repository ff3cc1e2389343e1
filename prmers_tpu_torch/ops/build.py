"""Build and load the port's CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds),
under `build/kernels/` at the repository root (listed in .gitignore). The
library's name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses it. It is loaded with ctypes; every
entry point returns the `cudaGetLastError()` of its launches, and
`check` raises on anything but 0.

Nothing here runs at import: the CPU tests import every module of the
port on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo"]

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64

# C entry points and their argument types (pointers and the stream as
# c_void_p: a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    "prmers_k1_p1c": [_P, _P, _P, _P, _P, _I, _P, _P, _U32, _P, _I, _I, _I,
                      _P],
    "prmers_k2_fused_c": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _P],
    "prmers_k3_p7c": [_P, _P, _P, _P, _P, _P, _U32, _P, _I, _U64, _I, _I,
                      _U64, _I, _I, _I, _P],
}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libprmers_kernels_{_digest()}.so")


def build() -> str:
    """Compile csrc/*.cu into the hashed library unless it exists; returns
    its path. Compiles into a temporary name and renames, so concurrent
    builders never load a half-written file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith(".cu")]
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + ARCH_FLAGS + NVCC_FLAGS + ["-I", CSRC, "-o", tmp] + cu
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, path)
    return path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
