"""Build and load the port's CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds),
under `build/kernels/` at the repository root (listed in .gitignore): one
`nvcc -c` per source, all started together, then one link. The
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
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_LL = ctypes.c_longlong

# C entry points and their argument types (pointers and the stream as
# c_void_p: a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    "prmers_k1_p1c": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _U32, _P, _P, _I,
                      _I, _I, _P],
    "prmers_k2_fused_c": [_P, _P, _P, _I] + [_P] * 10 + [_I] * 3 + [_P],
    "prmers_k3_p7c": [_P, _P, _P, _P, _P, _P, _U32, _P, _I, _U64, _I, _I,
                      _U64, _I, _I, _I, _I, _P, _LL, _P],
    "prmers_k5_axis1": [_P] * 7 + [_I] * 4 + [_P],
    "prmers_axis_fft_move": [_P] * 5 + [_I] * 5 + [_P],
    "prmers_r2_split_part": [_P] * 7 + [_I] * 5 + [_P],
    "prmers_k6_fused_c": [_P, _P, _P, _I, _P, _P, _I, _I, _P],
    "prmers_k6b_fused_c_invh": [_P, _P, _P, _I, _P, _I, _I, _P],
    "prmers_fused_c_part": [_P, _P, _I, _P, _P, _I, _I, _P],
    "prmers_k9_chain": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _U32] +
                       [_P] * 7 + [_I] * 4 + [_P],
    "prmers_k9_chain_part": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                             _U32] + [_P] * 7 + [_I] * 7 + [_P],
    "prmers_k4_axis0": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _U32, _P, _P, _I,
                        _I, _I, _P],
    "prmers_k7_block_carry": [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _P],
    "prmers_k4u_pass": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                        _U64, _P, _I, _P, _P, _U32, _I, _I, _I, _I, _I, _P],
    # the fft3161 transform (ops/kernels.py: K10-K12)
    "prmers_f3_fwd_stage": [_P] * 6 + [_I] * 4 + [_P, _U32, _U32, _U64,
                                                   _U64, _I, _I, _P],
    "prmers_f3_inv_stage": [_P] * 6 + [_I] * 4 + [_P, _P, _U64, _U32, _U32,
                                                   _U64, _U64, _I, _I, _P],
    "prmers_f3_pointwise": [_P] * 4 + [_I, _P],
    # the probes (ops/probes.py)
    "prmers_probe_reps": [_I, _P, _P, _I, _I, _LL, _P],
    "prmers_probe_bitcast": [_P, _P, _I, _I, _P],
    "prmers_probe_copy": [_I, _P, _P, _P],
    "prmers_probe_dot8": [_P, _P, _P, _I, _I, _I, _I, _P],
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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    for cmd, (out, rc) in zip(cmds, outs):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def build() -> str:
    """Compile csrc/*.cu into the hashed library unless it exists; returns
    its path. Each process compiles under its own temporary names and
    renames the library into place, so concurrent builds never load a
    half-written file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{path}.{os.getpid()}"
    cu = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(s)}.o" for s in cu]
    try:
        _run_all([[nvcc] + ARCH_FLAGS + NVCC_FLAGS +
                  ["-I", CSRC, "-c", src, "-o", obj]
                  for src, obj in zip(cu, objs)])
        _run_all([[nvcc] + ARCH_FLAGS + ["-shared", "-o", f"{tag}.tmp"] +
                  objs])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{tag}.tmp", path)
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
