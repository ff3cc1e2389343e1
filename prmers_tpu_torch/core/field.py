"""Goldilocks field GF(P), P = 2^64 - 2^32 + 1.

Scalar (python int) reference arithmetic used for plan generation and host-side
checks, plus an array-namespace-generic vectorized implementation that works
with both numpy (host precompute) and jax.numpy (device compute).

Semantics mirror the reference host field ops (reference: include/marin/arith.h:23-99)
but are re-derived from the mathematics of the Solinas prime; the vectorized
u64 code paths are built from 32-bit half-word products so the same algorithm
lowers to TPU (XLA emulates u64 with 32-bit lane pairs; Pallas kernels use the
explicit 32-bit form directly).
"""

from __future__ import annotations

P = (1 << 64) - (1 << 32) + 1
MP64 = (1 << 32) - 1  # -P mod 2^64
GENERATOR = 7  # multiplicative generator of GF(P)
# 554^((P-1)/192) == 2; used to build n-th roots of 2 for the IBDWT weights
ROOT_TWO_BASE = 554
ROOT_TWO_ORDER = 192  # ord(2) divides 192 in GF(P)


# ---------------------------------------------------------------------------
# Scalar (python int) ops — exact, arbitrary precision, host only
# ---------------------------------------------------------------------------

def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def inv(a: int) -> int:
    return pow(a, P - 2, P)


def exp(a: int, e: int) -> int:
    return pow(a, e, P)


def root_nth(n: int) -> int:
    """Primitive n-th root of unity (n must divide P-1)."""
    assert (P - 1) % n == 0
    return pow(GENERATOR, (P - 1) // n, P)


def root_two_nth(n: int) -> int:
    """n-th root of 2: an element r with r^n == 2 (n must divide (P-1)/192)."""
    assert ((P - 1) // ROOT_TWO_ORDER) % n == 0
    return pow(ROOT_TWO_BASE, (P - 1) // ROOT_TWO_ORDER // n, P)


# ---------------------------------------------------------------------------
# Vectorized ops, generic over array namespace (numpy or jax.numpy)
# ---------------------------------------------------------------------------

class FieldOps:
    """Vectorized Goldilocks ops over u64 arrays for a given array namespace.

    `xp` is either numpy or jax.numpy. All inputs/outputs are u64 arrays with
    values in [0, P). Internal products use 32-bit half-word decomposition so
    every intermediate fits (wrapping) u64 arithmetic.
    """

    def __init__(self, xp):
        self.xp = xp
        self.P = xp.uint64(P)
        self.MP64 = xp.uint64(MP64)
        self.M32 = xp.uint64(0xFFFFFFFF)
        self._u64 = xp.uint64

    def u64(self, v):
        return self.xp.asarray(v, dtype=self.xp.uint64)

    # -- modular add/sub: inputs < P ------------------------------------
    def add(self, a, b):
        xp = self.xp
        s = a + b  # wrapping
        return xp.where(a >= self.P - b, s + self.MP64, s)

    def sub(self, a, b):
        xp = self.xp
        d = a - b  # wrapping
        return xp.where(a < b, d - self.MP64, d)

    def neg(self, a):
        xp = self.xp
        return xp.where(a == 0, a, self.P - a)

    # -- 64x64 -> 128 multiply as (lo, hi) ------------------------------
    def mul_wide(self, a, b):
        xp = self.xp
        a0 = a & self.M32
        a1 = a >> self._u64(32)
        b0 = b & self.M32
        b1 = b >> self._u64(32)
        m00 = a0 * b0
        m01 = a0 * b1
        m10 = a1 * b0
        m11 = a1 * b1
        mid = m01 + m10  # may wrap once
        midc = xp.where(mid < m01, self._u64(1), self._u64(0))
        lo = m00 + (mid << self._u64(32))  # wrapping
        loc = xp.where(lo < m00, self._u64(1), self._u64(0))
        hi = m11 + (mid >> self._u64(32)) + (midc << self._u64(32)) + loc
        return lo, hi

    # -- Solinas reduction of a 128-bit value < P^2 ---------------------
    def reduce128(self, lo, hi):
        # hi*2^64 + lo == lo + (hi mod 2^32)*(2^32 - 1)... derived:
        # 2^64 == 2^32 - 1 (mod P), 2^96 == -1 (mod P)
        xp = self.xp
        r = xp.where(lo >= self.P, lo - self.P, lo)  # r < P
        hi_lo = hi & self.M32
        t = (hi_lo << self._u64(32)) - hi_lo  # == hi_lo * (2^32 - 1) < P
        r = self.add(r, t)
        return self.sub(r, hi >> self._u64(32))

    def mul(self, a, b):
        lo, hi = self.mul_wide(a, b)
        return self.reduce128(lo, hi)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_scalar(self, a, c: int):
        """Multiply array by a python-int field constant (broadcast)."""
        return self.mul(a, self._u64(c % P))

    def pow_const(self, a, e: int):
        """a ** e for python-int exponent (square-and-multiply, host loop)."""
        xp = self.xp
        r = xp.full_like(a, self._u64(1))
        base = a
        while e > 0:
            if e & 1:
                r = self.mul(r, base)
            e >>= 1
            if e:
                base = self.sqr(base)
        return r

    def powers(self, base: int, count: int):
        """[base^0, base^1, ..., base^(count-1)] via doubling (log steps)."""
        xp = self.xp
        out = xp.ones((1,), dtype=xp.uint64)
        cur = base % P
        while out.shape[0] < count:
            fac = xp.full((out.shape[0],), self._u64(cur), dtype=xp.uint64)
            out = xp.concatenate([out, self.mul(out, fac)])
            cur = (cur * cur) % P
        return out[:count]
