"""Goldilocks GF(P) arithmetic in plain torch, P = 2^64 - 2^32 + 1.

Counterpart of prmers_tpu/ops/pallas/gl64.py. The CUDA kernels use
csrc/gl64.cuh (native u64, __umul64hi, the Solinas fold 2^64 = 2^32 - 1);
this module is the plain version the CPU runs and the kernels are held
against.

torch has no usable unsigned 64-bit arithmetic on the CPU (uint32/uint64
add, sub, shift and compare raise), so a value is a pair (lo, hi) of int64
tensors, each word in [0, 2^32). Values are lazy: any v = lo + hi*2^32 <
2^64 in the right residue class; `canon` reduces to [0, P).

Registers and kernel buffers hold the same 64-bit pattern in ONE int64
tensor (`join`); `split` recovers the pair. torch's int64 `<<` wraps like
u64 and `>>` sign-extends, so the masks in `split` make both exact.

Products use 16-bit limbs: a limb product is < 2^32 and a sum of the few
products that share a position stays far below 2^63; `_fold7` turns the
seven limb-position sums back into a lazy pair with 2^64 = 2^32 - 1 and
2^96 = -1. Matrix products (`matmul_mod`) take the same limbs through
float64 matmuls, exact while each dot stays below 2^53 (512 terms of
2^32 is 2^41).
"""

from __future__ import annotations

import torch

P = (1 << 64) - (1 << 32) + 1
M32 = 0xFFFFFFFF
M16 = 0xFFFF


# -- packing -----------------------------------------------------------------

def split(x: torch.Tensor):
    """int64 tensor holding u64 bit patterns -> (lo, hi) words."""
    return x & M32, (x >> 32) & M32


def join(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) words -> int64 tensor holding the u64 bit pattern."""
    return lo | (hi << 32)


def norm(lo: torch.Tensor, hi: torch.Tensor):
    """Signed word sums (|lo|, |hi| < 2^61) of v = lo + hi*2^32 -> a lazy
    pair with both words in [0, 2^32). Each round moves the low word's
    overflow up and folds the high word's overflow h*2^64 back as
    h*(2^32 - 1); three rounds settle every input in range."""
    for _ in range(3):
        c = lo >> 32
        lo = lo & M32
        hi = hi + c
        h2 = hi >> 32
        hi = (hi & M32) + h2
        lo = lo - h2
    return lo, hi


def _fold7(T):
    """Seven limb-position sums T[k] (value sum_k T[k] * 2^(16k), each
    T[k] < 2^43) -> lazy pair mod P."""
    w0 = T[0] + (T[1] << 16)
    w1 = T[2] + (T[3] << 16)
    w2 = T[4] + (T[5] << 16)
    w3 = T[6]
    # w0 + w1*2^32 + w2*2^64 + w3*2^96 = (w0 - w2 - w3) + (w1 + w2)*2^32
    return norm(w0 - w2 - w3, w1 + w2)


def _limbs(lo, hi):
    return [lo & M16, lo >> 16, hi & M16, hi >> 16]


# -- modular ops (lazy in, lazy out) ----------------------------------------

def add(a0, a1, b0, b1):
    return norm(a0 + b0, a1 + b1)


def sub(a0, a1, b0, b1):
    return norm(a0 - b0, a1 - b1)


def mul(a0, a1, b0, b1):
    A = _limbs(a0, a1)
    B = _limbs(b0, b1)
    T = [None] * 7
    for i in range(4):
        for j in range(4):
            t = A[i] * B[j]
            T[i + j] = t if T[i + j] is None else T[i + j] + t
    return _fold7(T)


def sqr(a0, a1):
    return mul(a0, a1, a0, a1)


def mul_small(a0, a1, s):
    """Multiply by a small constant or tensor s < 2^32."""
    if not isinstance(s, torch.Tensor):
        s = torch.tensor(int(s), dtype=torch.int64, device=a0.device)
    return mul(a0, a1, s & M32, torch.zeros_like(s))


def const(v: int, like: torch.Tensor):
    """A python int (mod P) as a broadcastable pair on like's device."""
    v %= P
    return (torch.tensor(v & M32, dtype=torch.int64, device=like.device),
            torch.tensor(v >> 32, dtype=torch.int64, device=like.device))


def shiftmul(a0, a1, e: int):
    """a * 2^e mod P for a static e in [0, 96) (2^96 = -1)."""
    assert 0 <= e < 96
    c0, c1 = const(pow(2, e, P), a0)
    return mul(a0, a1, c0, c1)


def halve_where(a0, a1, mask):
    """a/2 mod P where mask: (a >> 1) + lsb * (P + 1)/2, no wrap."""
    lsb = a0 & 1
    h0 = (a0 >> 1) | ((a1 & 1) << 31)
    h1 = a1 >> 1
    r0, r1 = norm(h0 + lsb * 0x80000001, h1 + lsb * 0x7FFFFFFF)
    return torch.where(mask, r0, a0), torch.where(mask, r1, a1)


def double_where(a0, a1, mask):
    """2a mod P where mask (the 2^64 overflow folds as 2^32 - 1)."""
    r0, r1 = norm(a0 << 1, a1 << 1)
    return torch.where(mask, r0, a0), torch.where(mask, r1, a1)


def canon(a0, a1):
    """Lazy pair -> canonical [0, P): a < 2^64 < 2P needs at most one
    subtract, and a >= P exactly when hi = 2^32 - 1 and lo >= 1."""
    ge = (a1 == M32) & (a0 >= 1)
    return torch.where(ge, a0 - 1, a0), torch.where(ge, 0, a1)


# -- packed (u64-in-int64) helpers for the kernels' plain versions -----------

def mulmod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return join(*mul(*split(x), *split(y)))


def canon64(x: torch.Tensor) -> torch.Tensor:
    return join(*canon(*split(x)))


def matmul_mod(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(A @ B) mod P for packed u64 operands A (..., K, J) and B (..., J, N)
    with J <= 512 (the radix-5 r2 DFT has J = 320): sixteen float64 limb
    matmuls, exact below 2^53, and each position sum of four of them below
    the 2^43 that _fold7 takes."""
    assert A.shape[-1] <= 512
    Al = [((A >> (16 * i)) & M16).to(torch.float64) for i in range(4)]
    Bl = [((B >> (16 * i)) & M16).to(torch.float64) for i in range(4)]
    T = [None] * 7
    for i in range(4):
        for j in range(4):
            t = torch.matmul(Al[i], Bl[j])
            T[i + j] = t if T[i + j] is None else T[i + j] + t
    return join(*_fold7([t.to(torch.int64) for t in T]))


def from_numpy_u64(a, device) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bit pattern."""
    import numpy as np
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_numpy_u64(x: torch.Tensor):
    """int64 tensor of u64 bit patterns -> numpy uint64 array."""
    import numpy as np
    return x.detach().cpu().contiguous().numpy().view(np.uint64).copy()
