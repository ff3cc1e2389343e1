"""Quadratic-extension fields GF(q^2) for q in {M31, M61} — the second
arithmetic path ("fft3161"), the TPU analog of the reference's Aevum
GF(M31^2) x GF(M61^2) paired integer NTT (reference: third_party/aevum/
src/cl/math.cl:618-640 Mersenne folds, FFTConfig.h FFT3161 type).

Why these fields: reduction mod 2^s - 1 is a shift-fold, q31*q61 gives a
~92-bit CRT coefficient range (vs Goldilocks' 64), so the same exponent
fits a transform roughly half the size. Structure used throughout:

  * q = 2^s - 1, q ≡ 3 (mod 4) -> x^2 + 1 irreducible, GF(q^2) = a + b i.
  * ord(2) = s in GF(q)*, so the n-th root of TWO (IBDWT weights) is
    2^(n^-1 mod s) — a power of two, and it lies in the BASE field.
  * |GF(q^2)*| = (q-1)(q+1), q+1 = 2^s: the 2-power-order roots of unity
    live on the norm-1 circle a^2 + b^2 = 1; odd(3^a)-order roots live in
    the base field. n | 2^(s+1) * 3^2 transforms are supported.

Scalar (python int) reference ops for table generation; vectorized pair
ops over any array namespace for device compute.

Port: a copy of prmers_tpu/core/field2.py. Fq2, F31, F61, crt_pair,
Q31_INV_MOD_Q61, _prime_factors and Fq2Ops are the JAX package's
verbatim (Fq2Ops on numpy is the host oracle). One addition: Fq2Torch,
the same pair ops on torch int64 tensors for the plain versions of the
fft3161 kernels (ops/ntt2.py). torch on the CPU has no uint64 add,
shift or compare, and Fq2Ops.mulq's 32-bit halves make a product p00 up
to 2^64, so Fq2Torch splits at 31 bits instead: every intermediate stays
below 2^63 and every output is canonical (< q), equal to Fq2Ops' output
for the same canonical inputs.
"""

from __future__ import annotations

import functools

import torch

M31 = (1 << 31) - 1
M61 = (1 << 61) - 1
S31, S61 = 31, 61


def _fold(x: int, q: int) -> int:
    return x % q


class Fq2:
    """Scalar GF(q^2) arithmetic, elements as (re, im) int pairs."""

    def __init__(self, q: int, s: int):
        self.q = q
        self.s = s

    def mul(self, a, b):
        q = self.q
        ar, ai = a
        br, bi = b
        return ((ar * br - ai * bi) % q, (ar * bi + ai * br) % q)

    def sqr(self, a):
        q = self.q
        ar, ai = a
        return ((ar * ar - ai * ai) % q, (2 * ar * ai) % q)

    def pow(self, a, e: int):
        r = (1, 0)
        while e:
            if e & 1:
                r = self.mul(r, a)
            a = self.sqr(a)
            e >>= 1
        return r

    def inv(self, a):
        # (a + bi)^-1 = (a - bi) / (a^2 + b^2); base-field inverse by
        # Fermat (q prime)
        q = self.q
        ar, ai = a
        n = (ar * ar + ai * ai) % q
        ninv = pow(n, q - 2, q)
        return (ar * ninv % q, (q - ai) * ninv % q)

    def order_is(self, a, n: int) -> bool:
        if self.pow(a, n) != (1, 0):
            return False
        for f in _prime_factors(n):
            if self.pow(a, n // f) == (1, 0):
                return False
        return True

    @functools.lru_cache(maxsize=None)
    def root_two(self, n: int):
        """x (in the base field) with x^n = 2: x = 2^(n^-1 mod s)."""
        assert n % self.s != 0, "n must be coprime to ord(2)"
        a = pow(n, -1, self.s)
        return (pow(2, a, self.q), 0)

    @functools.lru_cache(maxsize=None)
    def root_unity(self, n: int):
        """Primitive n-th root of unity, n = 2^k * 3^a (a <= 2)."""
        q, s = self.q, self.s
        k = 0
        m = n
        while m % 2 == 0:
            m //= 2
            k += 1
        assert m in (1, 3, 9), f"unsupported odd part {m} of n={n}"
        assert k <= s + 1, f"2-adic order {k} exceeds {s + 1}"
        # The whole root family must be CONSISTENT under the mixed-radix
        # stage recursion: root_unity(L)^(L/r) == root_unity(r) for every
        # r | L of the supported form (the DIF stage at length L assumes
        # its radix-r DFT matrix uses w_L^(L/r)). Raising the 2-part
        # c^(2^(s-k)) to L/2^j multiplies its exponent by the odd cofactor
        # m, and the 3-part g3 to L/3^b by the even cofactor 2^k — so fold
        # the CRT inverses in: u = m^-1 mod 2^k, v = (2^k)^-1 mod m. (The
        # uncorrected family satisfied the identity only when the cofactor
        # was 1 mod the other part — n=3*2^even passed, n=3*2^odd broke.)
        parts = (1, 0)
        if k:
            if k <= s:
                c = self._circle_gen()           # order 2^s
                u = pow(m, -1, 1 << k)
                parts = self.mul(parts, self.pow(c, (1 << (s - k)) * u))
            else:  # k == s + 1: multiply an order-2^s circle element by a
                # base-field sqrt chain is impossible; use g2 = c * j where
                # j^2 = c descends outside the circle — not needed for the
                # plan sizes (k <= s always holds for n <= 2^31)
                raise AssertionError("k == s+1 unsupported")
        if m > 1:
            g3 = self._odd_gen(m)
            v = pow(1 << k, -1, m)
            parts = self.mul(parts, self.pow(g3, v))
        return parts

    @functools.lru_cache(maxsize=None)
    def _circle_gen(self):
        """Element of order exactly 2^s on the norm-1 circle
        (a^2 + b^2 = 1): ((1 - t^2) + 2t i) / (1 + t^2) for small t,
        verified by order check."""
        q, s = self.q, self.s
        for t in range(2, 50):
            den = pow(1 + t * t, q - 2, q)
            c = ((1 - t * t) % q * den % q, 2 * t * den % q)
            if self.order_is(c, 1 << s):
                return c
        raise RuntimeError("no circle generator found")

    @functools.lru_cache(maxsize=None)
    def _odd_gen(self, m: int):
        """Base-field element of order exactly m (m in {3, 9}). The
        order-3 generator is the CUBE of the order-9 one so the two
        families compose under the stage recursion (root_unity
        consistency: w_9^3 == w_3)."""
        q = self.q
        assert (q - 1) % m == 0
        if m == 3 and (q - 1) % 9 == 0:
            return self.pow(self._odd_gen(9), 3)
        for g in range(2, 100):
            c = (pow(g, (q - 1) // m, q), 0)
            if self.order_is(c, m):
                return c
        raise RuntimeError("no odd-order generator found")


F31 = Fq2(M31, S31)
F61 = Fq2(M61, S61)

# CRT combine: value = c31 + q31 * ((c61 - c31) * q31^-1 mod q61)
Q31_INV_MOD_Q61 = pow(M31, -1, M61)


def crt_pair(c31: int, c61: int) -> int:
    """Exact value in [0, q31*q61) from residues mod q31 and q61."""
    t = (c61 - c31) * Q31_INV_MOD_Q61 % M61
    return c31 + M31 * t


# ---------------------------------------------------------------------------
# Vectorized pair ops over an array namespace (u64 arrays, values < q)
# ---------------------------------------------------------------------------

class Fq2Ops:
    """GF(q^2) over u64 arrays; elements are (re, im) array pairs.

    q < 2^61 so a*b needs 122-bit products: computed via 32-bit half
    decomposition and folded with 2^s ≡ 1 shifts (the Mersenne fold,
    reference math.cl:618-640 '(a & M) + (a >> k)').
    """

    def __init__(self, xp, q: int, s: int):
        self.xp = xp
        self.q = q
        self.s = s
        self.mask = xp.uint64(q)

    # -- base field --------------------------------------------------------
    def _fold1(self, x):
        """One fold step of a value < 2^64: x mod 2^s-1 partially."""
        xp = self.xp
        s = xp.uint64(self.s)
        return (x & self.mask) + (x >> s)

    def norm(self, x):
        """Canonicalize a (< 2^64) value to [0, q)."""
        xp = self.xp
        x = self._fold1(self._fold1(x))
        return xp.where(x >= self.mask, x - self.mask, x)

    def mulq(self, a, b):
        """(a * b) mod q for a, b < q < 2^61 via 32-bit halves."""
        xp = self.xp
        M32 = xp.uint64(0xFFFFFFFF)
        a0 = a & M32
        a1 = a >> xp.uint64(32)
        b0 = b & M32
        b1 = b >> xp.uint64(32)
        s = self.s
        # product = p00 + (p01 + p10) 2^32 + p11 2^64
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        p11 = a1 * b1          # < 2^(2(61-32)) = 2^58
        mid = p01 + p10        # < 2^59
        # fold: 2^s ≡ 1 -> x * 2^e ≡ x * 2^(e mod s)
        lo = p00 & M32 | ((mid & M32) << xp.uint64(32))  # may wrap: handle
        # safer assembly in parts, each already < 2^64:
        # value = p00 + mid*2^32 + p11*2^64
        #       ≡ p00 + fold(mid, 32) + fold(p11, 64)  -- shifts mod 2^s
        r = self._fold1(p00)
        r = r + self._shift_fold(mid, 32)
        r = r + self._shift_fold(p11, 64)
        return self.norm(r)

    def _shift_fold(self, x, e: int):
        """x * 2^e mod q folded to < 2^63ish, x < 2^60."""
        xp = self.xp
        s = self.s
        e = e % s
        if e == 0:
            return self._fold1(x)
        lo_bits = xp.uint64(s - e)
        hi = x >> lo_bits                      # top bits -> wrap to low
        lo = x & ((xp.uint64(1) << lo_bits) - xp.uint64(1))
        return (lo << xp.uint64(e)) + hi       # < 2^s + x>>.. — small

    def addq(self, a, b):
        xp = self.xp
        r = a + b
        return xp.where(r >= self.mask, r - self.mask, r)

    def subq(self, a, b):
        xp = self.xp
        return xp.where(a >= b, a - b, a + self.mask - b)

    # -- extension field (re, im) pairs -------------------------------------
    def mul(self, x, y):
        xr, xi = x
        yr, yi = y
        rr = self.subq(self.mulq(xr, yr), self.mulq(xi, yi))
        ri = self.addq(self.mulq(xr, yi), self.mulq(xi, yr))
        return rr, ri

    def sqr(self, x):
        xr, xi = x
        rr = self.subq(self.mulq(xr, xr), self.mulq(xi, xi))
        ri = self.mulq(self.addq(xr, xr), xi)
        return rr, ri

    def add(self, x, y):
        return self.addq(x[0], y[0]), self.addq(x[1], y[1])

    def sub(self, x, y):
        return self.subq(x[0], y[0]), self.subq(x[1], y[1])

    def mul_i(self, x):
        """x * i = (-im, re)."""
        xp = self.xp
        xr, xi = x
        zero = xp.uint64(0) * xi
        return self.subq(zero, xi), xr


def _prime_factors(n: int):
    fs = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.add(d)
            n //= d
        d += 1
    if n > 1:
        fs.add(n)
    return fs


# ---------------------------------------------------------------------------
# The same pair ops on torch int64 tensors (the port's plain versions)
# ---------------------------------------------------------------------------

_M31L = (1 << 31) - 1


class Fq2Torch:
    """GF(q^2) over int64 tensors (or python ints) holding canonical
    values < q; every op returns canonical values. q = M31 or M61."""

    def __init__(self, q: int, s: int):
        self.q = q
        self.s = s

    def _fold(self, x):
        return (x & self.q) + (x >> self.s)

    def _canon(self, x):
        """x in [0, 2q) -> [0, q)."""
        return torch.where(x >= self.q, x - self.q, x)

    def norm(self, x):
        """Canonicalize a u64 bit pattern held in int64: the shift is
        logical (the sign bit is the pattern's bit 63)."""
        x = (x & self.q) + ((x >> self.s) & ((1 << (64 - self.s)) - 1))
        return self._canon(self._fold(x))

    def mulq(self, a, b):
        """(a * b) mod q for canonical a, b. M31: the product is below
        2^62. M61: halves at 31 bits, p00 < 2^62, mid < 2^62, p11 <
        2^60; with 2^61 = 1, mid 2^31 = (mid & 2^30-1) 2^31 + (mid >>
        30) and p11 2^62 = 2 p11, so the sum stays below 2^63."""
        if self.s == 31:
            return self._canon(self._fold(self._fold(a * b)))
        a0, a1 = a & _M31L, a >> 31
        b0, b1 = b & _M31L, b >> 31
        mid = a0 * b1 + a1 * b0
        r = (self._fold(a0 * b0) + ((mid & ((1 << 30) - 1)) << 31)
             + (mid >> 30) + 2 * (a1 * b1))
        return self._canon(self._fold(r))

    def addq(self, a, b):
        return self._canon(a + b)

    def subq(self, a, b):
        return torch.where(a >= b, a - b, a + self.q - b)

    def mul(self, x, y):
        xr, xi = x
        yr, yi = y
        rr = self.subq(self.mulq(xr, yr), self.mulq(xi, yi))
        ri = self.addq(self.mulq(xr, yi), self.mulq(xi, yr))
        return rr, ri

    def sqr(self, x):
        xr, xi = x
        rr = self.subq(self.mulq(xr, xr), self.mulq(xi, xi))
        ri = self.mulq(self.addq(xr, xr), xi)
        return rr, ri

    def add(self, x, y):
        return self.addq(x[0], y[0]), self.addq(x[1], y[1])

    def sub(self, x, y):
        return self.subq(x[0], y[0]), self.subq(x[1], y[1])

    def neg(self, x):
        return self.subq(0 * x[0], x[0]), self.subq(0 * x[1], x[1])

    def mul_i(self, x):
        """x * i = (-im, re)."""
        xr, xi = x
        return self.subq(0 * xi, xi), xr


T31 = Fq2Torch(M31, S31)
T61 = Fq2Torch(M61, S61)
