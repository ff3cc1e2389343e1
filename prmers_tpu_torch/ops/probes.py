"""The microbenchmark and probe kernels: wrappers, plain versions, counters.

Counterparts of the five TPU probes under tools/ (each a pallas_call that
measured a rate of the TPU or asked what Mosaic could lower), built like
the squaring kernels (ops/build.py) and used by prmers_tpu_torch/tools/:

  probe_vpu      csrc/probe_reps.cu     y = y * x + 1 on u32 words, reps
                                        times (microbench3.py:77)
  probe_mulmod   csrc/probe_reps.cu     a = a * b mod P, reps times
                                        (microbench3.py:152)
  probe_fields   csrc/probe_reps.cu     the rep loop of gl64 mul / sqr,
                                        GF(M31^2) mul / sqr, GF(M61^2)
                                        mul / sqr (microbench_fields.py:71)
  probe_bitcast  csrc/probe_bitcast.cu  u32 -> 4 x int8 in the card's byte
                                        order (probe_bitcast.py:34)
  probe_shapes   csrc/probe_shapes.cu   cases a-n of exp_mosaic_shapes.py
                                        :15 and exp_mosaic_shapes2.py:15

Data are u32 words held in int32 tensors (the bit patterns the TPU's u32
arrays hold; a rep op's planes stacked on dim 0), int8 and int32 as they
are. Each wrapper takes its plain torch version for a CPU tensor and
launches its kernel for a CUDA tensor, and `calls` counts the calls that
launched. The plain versions compute on int64 words in [0, 2^32) with the
port's gl64 and mers ops; a rep op's results equal its kernel's after
canon (canon_planes), the others' bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from . import gl64 as gl
from . import mers

KERNELS = ("probe_vpu", "probe_mulmod", "probe_fields", "probe_bitcast",
           "probe_shapes")
SOURCES = {
    "probe_vpu": "prmers_tpu_torch/csrc/probe_reps.cu",
    "probe_mulmod": "prmers_tpu_torch/csrc/probe_reps.cu",
    "probe_fields": "prmers_tpu_torch/csrc/probe_reps.cu",
    "probe_bitcast": "prmers_tpu_torch/csrc/probe_bitcast.cu",
    "probe_shapes": "prmers_tpu_torch/csrc/probe_shapes.cu",
}
REPLACES = {
    "probe_vpu": "tools/microbench3.py:77",
    "probe_mulmod": "tools/microbench3.py:152",
    "probe_fields": "tools/microbench_fields.py:71",
    "probe_bitcast": "tools/probe_bitcast.py:34",
    "probe_shapes": "tools/exp_mosaic_shapes.py:15, "
                    "tools/exp_mosaic_shapes2.py:15",
}
calls = {name: 0 for name in KERNELS}

M32 = gl.M32

# rep ops: (id in probe_reps.cu, planes in)
REP_OPS = {"vpu": (0, 1), "gl_mul": (1, 4), "gl_sqr": (2, 2),
           "m31_mul": (3, 4), "m31_sqr": (4, 2), "m61_mul": (5, 8),
           "m61_sqr": (6, 4)}
FIELD_OPS = ("gl_mul", "gl_sqr", "m31_mul", "m31_sqr", "m61_mul", "m61_sqr")


def reset_calls() -> None:
    for name in KERNELS:
        calls[name] = 0


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cpu"


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def words(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2^32)."""
    return x.to(torch.int64) & M32


def bits32(w: torch.Tensor) -> torch.Tensor:
    """int64 words (any value; the low 32 bits count) -> int32 patterns."""
    return (((w & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


# ---------------------------------------------------------------------------
# probe_vpu, probe_mulmod, probe_fields: the rep loop
# ---------------------------------------------------------------------------

_M31, _M61 = mers.M31C(), mers.M61C()


def _rep_step(op: str, w: list) -> list:
    if op == "gl_mul":
        return list(gl.mul(*w)) + w[2:]
    if op == "gl_sqr":
        return list(gl.sqr(*w))
    if op == "m31_mul":
        return list(_M31.mul(*w)) + w[2:]
    if op == "m31_sqr":
        return list(_M31.sqr(*w))
    if op == "m61_mul":
        return list(_M61.mul(*w)) + w[4:]
    if op == "m61_sqr":
        return list(_M61.sqr(*w))
    raise ValueError(op)


def reps_plain(op: str, x: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain rep loop: x (n_in, ...) int32 planes -> the n_in planes after
    reps applications (vpu: y = y * x + 1 from y = x, one plane)."""
    w = [words(p) for p in x]
    if op == "vpu":
        y = w[0]
        for _ in range(reps):
            y = (y * w[0] + 1) & M32
        w = [y]
    else:
        for _ in range(reps):
            w = _rep_step(op, w)
    return torch.stack([bits32(p) for p in w])


def _reps(name: str, op: str, x: torch.Tensor, reps: int,
          n_out: int) -> torch.Tensor:
    op_id, n_in = REP_OPS[op]
    if x.dtype != torch.int32 or not x.is_contiguous() or x.dim() < 2 or \
            x.shape[0] != n_in:
        raise ValueError(f"{op} takes contiguous int32 ({n_in}, ...) planes "
                         f"(got {x.dtype} {tuple(x.shape)})")
    if not 0 <= reps < (1 << 31):
        raise ValueError(f"reps={reps}")
    if _on_cpu(x):
        return reps_plain(op, x, reps)[:n_out].contiguous()
    out = torch.empty((n_out,) + tuple(x.shape[1:]), dtype=torch.int32,
                      device=x.device)
    err = build.lib().prmers_probe_reps(op_id, x.data_ptr(), out.data_ptr(),
                                        n_out, reps, x[0].numel(), _stream())
    calls[name] += 1
    build.check(err, name)
    return out


def vpu(x: torch.Tensor, reps: int) -> torch.Tensor:
    """probe_vpu: x (R, C) int32 -> y after reps of y = y * x + 1."""
    return _reps("probe_vpu", "vpu", x.unsqueeze(0), reps, 1)[0]


def mulmod(x: torch.Tensor, reps: int) -> torch.Tensor:
    """probe_mulmod: x (4, R, C) int32 = (alo, ahi, blo, bhi) -> (2, R, C),
    the lazy a * b^reps mod P (microbench3's olo, ohi)."""
    return _reps("probe_mulmod", "gl_mul", x, reps, 2)


def fields(op: str, x: torch.Tensor, reps: int) -> torch.Tensor:
    """probe_fields: one of FIELD_OPS on its planes x (n_in, R, C) int32,
    reps times; every plane out (the b operands pass through)."""
    if op not in FIELD_OPS:
        raise ValueError(op)
    return _reps("probe_fields", op, x, reps, REP_OPS[op][1])


def canon_planes(op: str, x: torch.Tensor) -> torch.Tensor:
    """A rep op's planes (int32) reduced to canonical words (int64), so
    that the kernel's and the plain version's lazy forms compare: gl64
    pairs mod P, M31 words mod 2^31 - 1, M61 pairs mod 2^61 - 1; vpu as
    it is."""
    w = [words(p) for p in x]
    if op == "vpu":
        return torch.stack(w)
    out = []
    step = 1 if op.startswith("m31") else 2
    for i in range(0, len(w), step):
        if op.startswith("gl"):
            out += list(gl.canon(w[i], w[i + 1]))
        elif op.startswith("m31"):
            out.append(_M31.canon(w[i]))
        else:
            out += list(_M61.canon(w[i], w[i + 1]))
    return torch.stack(out)


def rep_inputs(op: str, shape, seed: int = 7, device="cpu") -> torch.Tensor:
    """Seeded planes for a rep op, each word below 2^30 as in the TPU
    tools' inputs (a lazy form every op takes)."""
    rng = np.random.default_rng(seed)
    n_in = REP_OPS[op][1]
    a = rng.integers(0, 1 << 30, size=(n_in,) + tuple(shape),
                     dtype=np.int64)
    return torch.from_numpy(a.astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# probe_bitcast
# ---------------------------------------------------------------------------

def bitcast_plain(x: torch.Tensor) -> torch.Tensor:
    """(L, C) int32 -> (4L, C) int8: row 4l + b is byte b of word l as the
    words lie in memory."""
    L, C = x.shape
    return x.contiguous().view(torch.int8).reshape(L, C, 4) \
        .permute(0, 2, 1).reshape(4 * L, C).contiguous()


def bitcast(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("bitcast takes a contiguous int32 (L, C) tensor")
    if _on_cpu(x):
        return bitcast_plain(x)
    L, C = x.shape
    out = torch.empty((4 * L, C), dtype=torch.int8, device=x.device)
    err = build.lib().prmers_probe_bitcast(x.data_ptr(), out.data_ptr(), L,
                                           C, _stream())
    calls["probe_bitcast"] += 1
    build.check(err, "probe_bitcast")
    return out


def bitcast_pattern(L: int = 8, C: int = 128) -> np.ndarray:
    """probe_bitcast.py's input: byte b of every word of row l is l*4 + b."""
    v = np.zeros((L, C), dtype=np.uint32)
    for l in range(L):
        v[l, :] = sum((l * 4 + b) << (8 * b) for b in range(4))
    return v


def bitcast_order(col: list) -> str:
    """Name the order of a probe_bitcast output column, as the TPU tool
    does."""
    L = len(col) // 4
    if col == [l * 4 + b for l in range(L) for b in range(4)]:
        return "interleaved"
    if col == [l * 4 + b for b in range(4) for l in range(L)]:
        return "plane-major"
    return "other"


# ---------------------------------------------------------------------------
# probe_shapes
# ---------------------------------------------------------------------------

# each case: its inputs ((shape, dtype) with "u32" an int32 tensor of u32
# words) and what it computes
SHAPE_CASES = {
    "a": ((((64, 8, 8, 128), "int32"),), "merge-mid (64,8,8,128)->(64,64,128)"),
    "b": ((((576, 512), "int8"), ((512, 64, 128), "int8")),
          "3D dot (576,512)@(512,64,128)"),
    "c": ((((64, 64, 128), "int8"),), "concat axis0 8x(64,64,128)"),
    "d": ((((576, 64, 128), "int32"),),
          "split-lead (576,64,128)->(9,64,64,128)"),
    "e": ((((576, 512), "int8"), ((512, 1024), "int8")),
          "2D dot (576,512)@(512,1024)"),
    "f": ((((64, 64, 128), "u32"),), "u8->i8 bitcast (64,64,128)"),
    "g": ((((512, 128), "int8"),), "lane-concat 8x(512,128)->(512,1024)"),
    "h": ((((576, 1024), "int32"),), "row-slice [64:128] of (576,1024)"),
    "i": ((((576, 1024), "int32"),), "lane-slice [:,128:256] of (576,1024)"),
    "j": ((((64, 64, 128), "u32"),), "scalar mid-index x[:,j,:] of "
                                     "(64,64,128)"),
    "k": ((((64, 8, 128), "u32"),), "per-slice store o[:,j,:] (64,8,128)"),
    "l": ((((64, 64, 128), "u32"),), "expand (64,128)->(64,1,128)"),
    "m": ((((64, 8, 128), "int8"),), "slices->lane-concat->(512,1024)"),
    "n": ((((576, 512), "int8"), ((512, 1024), "int8")),
          "dot+9 row-slice combine"),
}
_DOTS = ("b", "e", "n")


def shape_inputs(case: str, seed: int = 0, device="cpu") -> tuple:
    """Seeded inputs of a case (the TPU tools used ones; random values
    make the check mean something)."""
    rng = np.random.default_rng(seed * 31 + ord(case))
    out = []
    for shape, kind in SHAPE_CASES[case][0]:
        if kind == "int8":
            a = rng.integers(-128, 128, size=shape, dtype=np.int64)
            t = torch.from_numpy(a.astype(np.int8))
        elif kind == "int32":
            a = rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64)
            t = torch.from_numpy(a.astype(np.int32))
        else:
            a = rng.integers(0, 1 << 32, size=shape, dtype=np.int64)
            t = bits32(torch.from_numpy(a))
        out.append(t.to(device))
    return tuple(out)


def _dot_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ (K, N) -> int32, exact in float64 (|sum| < 2^23)."""
    return (w.double() @ x.reshape(x.shape[0], -1).double()).to(torch.int32)


def shape_plain(case: str, *xs: torch.Tensor) -> torch.Tensor:
    x = xs[0]
    if case == "a":
        return x.reshape(64, 64, 128).clone()
    if case == "b":
        return _dot_plain(*xs).reshape(576, 64, 128)
    if case == "c":
        return torch.cat([x] * 8, dim=0)
    if case == "d":
        return x.reshape(9, 64, 64, 128).clone()
    if case == "e":
        return _dot_plain(*xs)
    if case == "f":
        return (words(x) & 0xFF).to(torch.uint8).view(torch.int8)
    if case == "g":
        return torch.cat([x] * 8, dim=1)
    if case == "h":
        return x[64:128, :].contiguous()
    if case == "i":
        return x[:, 128:256].contiguous()
    if case == "j":
        return bits32(words(x[:, :8, :]).sum(dim=1))
    if case == "k":
        return bits32(words(x) + 1)
    if case == "l":
        return x[:, 0:1, :].contiguous()
    if case == "m":
        two_d = torch.cat([x[:, j, :] for j in range(8)], dim=1)
        return torch.cat([two_d] * 8, dim=0)
    if case == "n":
        return _dot_plain(*xs).reshape(9, 64, 1024).sum(dim=0).to(
            torch.int32)
    raise ValueError(case)


def _out_like(case: str, xs) -> torch.Tensor:
    """An empty output of the case's shape and type, on the inputs'
    device."""
    meta = shape_plain(case, *(torch.zeros_like(x, device="meta")
                               for x in xs))
    return torch.empty(meta.shape, dtype=meta.dtype, device=xs[0].device)


def shape_case(case: str, *xs: torch.Tensor) -> torch.Tensor:
    """One shape case: its plain version on the CPU, its kernel on the
    card."""
    want = SHAPE_CASES[case][0]
    if len(xs) != len(want) or any(
            tuple(x.shape) != s or not x.is_contiguous() or
            x.dtype != (torch.int8 if k == "int8" else torch.int32)
            for x, (s, k) in zip(xs, want)):
        raise ValueError(f"case {case} takes {want}")
    if _on_cpu(xs[0]):
        return shape_plain(case, *xs)
    out = _out_like(case, xs)
    lib = build.lib()
    if case in _DOTS:
        w, x = xs
        K = w.shape[1]
        N = x.numel() // K
        scratch = torch.empty((576, N), dtype=torch.int32,
                              device=x.device) if case == "n" else None
        err = lib.prmers_probe_dot8(
            w.data_ptr(), x.data_ptr(), out.data_ptr(), w.shape[0], N, K,
            64 if case == "n" else 0,
            None if scratch is None else scratch.data_ptr(), _stream())
    else:
        dims = tuple(xs[0].shape) + (1, 1)
        err = lib.prmers_probe_copy(ord(case), xs[0].data_ptr(),
                                    out.data_ptr(), out.numel(), *dims[:3],
                                    _stream())
    calls["probe_shapes"] += 1
    build.check(err, f"probe_shapes[{case}]")
    return out
