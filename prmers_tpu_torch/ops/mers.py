"""GF(M31^2) / GF(M61^2) complex arithmetic in plain torch: the port's copy
of prmers_tpu/ops/pallas/mers.py, the field ops of the second arithmetic
path ("fft3161") that tools/microbench_fields.py prices against gl64.

The JAX module runs on u32 arrays; torch has no usable unsigned 32-bit
arithmetic, so here every u32 word is an int64 tensor holding a value in
[0, 2^32), and each step that wraps mod 2^32 in the original masks its
result with M32. So every op returns the same words as the original for
the same words in, lazy forms included:

  * M31 plane: each component one word, lazy < 2^32; `red` folds to
    < 2^31 + 1 via x -> (x & M31) + (x >> 31).
  * M61 plane: each component a (lo, hi) word pair, lazy < 2^62 (hi <
    2^30); `red` folds to < 2^61 + 8.

csrc/mers.cuh holds the same operations as device functions (native u32
and u64 words there), for the microbenchmark kernel of csrc/probe_reps.cu.
"""

from __future__ import annotations

import numpy as np
import torch

M31 = (1 << 31) - 1
M61 = (1 << 61) - 1
M32 = 0xFFFFFFFF
_M29 = (1 << 29) - 1


class M31C:
    """GF(M31^2) = a + b*i (i^2 = -1) on u32 words, lazy < 2^32."""

    def red(self, x):
        """lazy32 -> < 2^31 + 1."""
        return (x & M31) + (x >> 31)

    def canon(self, x):
        r = self.red(self.red(x))          # < 2^31 + 1 -> <= 2^31
        return torch.where(r >= M31, r - M31, r)

    def _mul_base(self, a, b):
        """base mul of reduced inputs (< 2^31 + 1): lazy32 out. The product
        is below 2^63, so one int64 multiply gives the original's (lo, hi)
        words, and (lo & M31) + (lo >> 31 | hi << 1) is (p & M31) + (p >>
        31)."""
        p = a * b
        return (p & M31) + (p >> 31)

    def mul_base(self, a, b):
        return self._mul_base(self.red(a), self.red(b))

    def add_base(self, a, b):
        # red(x) can be exactly 2^31; double-red (<= 2^31 - 1) keeps the
        # u32 sum from wrapping
        return self.red(self.red(a)) + self.red(self.red(b))

    def sub_base(self, a, b):
        return (M31 + self.red(self.red(a))) - self.red(b)

    def mul(self, ar, ai, br, bi):
        """Complex schoolbook: 4 base muls."""
        rr, ri = self.red(ar), self.red(ai)
        sr, si = self.red(br), self.red(bi)
        t1 = self._mul_base(rr, sr)
        t2 = self._mul_base(ri, si)
        t3 = self._mul_base(rr, si)
        t4 = self._mul_base(ri, sr)
        return self.sub_base(t1, t2), self.add_base(t3, t4)

    def sqr(self, ar, ai):
        """(a+bi)^2 = (a+b)(a-b) + 2ab i: 2 base muls."""
        rr, ri = self.red(ar), self.red(ai)
        s = (rr + ri) & M32                 # wraps as the u32 sum does
        d = ((M31 + rr) - ri) & M32
        re = self._mul_base(self.red(s), self.red(d))
        ab = self._mul_base(rr, ri)
        return re, self.red(self.red(ab)) * 2


class M61C:
    """GF(M61^2) on (lo, hi) word pairs, lazy < 2^62 (hi < 2^30)."""

    def _addc(self, a, b):
        s = a + b
        return s & M32, s >> 32

    def _mul32(self, a, b):
        """u32 x u32 -> (lo, hi) words. The int64 product wraps past 2^63
        as two's complement, which leaves both words right once masked."""
        p = a * b
        return p & M32, (p >> 32) & M32

    def red(self, a0, a1):
        """lazy62 -> < 2^61 + 8: (x & M61) + (x >> 61)."""
        s0, c = self._addc(a0, a1 >> 29)
        return s0, (a1 & _M29) + c

    def canon(self, a0, a1):
        r0, r1 = self.red(*self.red(a0, a1))
        ge = (r1 > 0x1FFFFFFF) | ((r1 == 0x1FFFFFFF) & (r0 == M32))
        d0 = (r0 - M32) & M32
        d1 = (r1 - 0x1FFFFFFF - (r0 < M32).long()) & M32
        return torch.where(ge, d0, r0), torch.where(ge, d1, r1)

    def _mul_base(self, a0, a1, b0, b1):
        """base mul of reduced inputs (< 2^61 + 8): lazy62 out."""
        ll0, ll1 = self._mul32(a0, b0)
        lh0, lh1 = self._mul32(a0, b1)
        hl0, hl1 = self._mul32(a1, b0)
        hh0, hh1 = self._mul32(a1, b1)
        r1, c1 = self._addc(ll1, lh0)
        r1, c1b = self._addc(r1, hl0)
        c1 = c1 + c1b
        r2, c2 = self._addc(lh1, hl1)
        r2, c2b = self._addc(r2, hh0)
        r2, c2c = self._addc(r2, c1)
        r3 = (hh1 + c2 + c2b + c2c) & M32
        # p = (r3:r2:r1:ll0) < 2^123; p mod M61 = (p & M61) + (p >> 61)
        h0 = ((r1 >> 29) | (r2 << 3)) & M32
        h1 = ((r2 >> 29) | (r3 << 3)) & M32
        s0, c = self._addc(ll0, h0)
        return s0, ((r1 & _M29) + h1 + c) & M32

    def mul_base(self, a0, a1, b0, b1):
        return self._mul_base(*self.red(a0, a1), *self.red(b0, b1))

    def add_base(self, a0, a1, b0, b1):
        r0, r1 = self.red(a0, a1)
        s0, s1 = self.red(b0, b1)
        t0, c = self._addc(r0, s0)
        return t0, (r1 + s1 + c) & M32

    def sub_base(self, a0, a1, b0, b1):
        """red(a) + 2*M61 - red(b): no borrow, folds to lazy62."""
        r0, r1 = self.red(a0, a1)
        s0, s1 = self.red(b0, b1)
        # 2*M61 = (0xFFFFFFFE, 0x3FFFFFFF)
        t0, c = self._addc(r0, 0xFFFFFFFE)
        t1 = (r1 + 0x3FFFFFFF + c) & M32
        d0 = (t0 - s0) & M32
        d1 = (t1 - s1 - (t0 < s0).long()) & M32
        s0b, c2 = self._addc(d0, d1 >> 29)
        return s0b, (d1 & _M29) + c2

    def mul(self, ar0, ar1, ai0, ai1, br0, br1, bi0, bi1):
        """Complex Karatsuba: 3 base muls."""
        t1 = self.mul_base(ar0, ar1, br0, br1)
        t2 = self.mul_base(ai0, ai1, bi0, bi1)
        sa = self.add_base(ar0, ar1, ai0, ai1)
        sb = self.add_base(br0, br1, bi0, bi1)
        t3 = self._mul_base(*self.red(*sa), *self.red(*sb))
        re = self.sub_base(*t1, *t2)
        im = self.sub_base(*self.sub_base(*t3, *t1), *t2)
        return re + im

    def sqr(self, ar0, ar1, ai0, ai1):
        """(a+b)(a-b) + 2ab i: 2 base muls."""
        s = self.add_base(ar0, ar1, ai0, ai1)
        d = self.sub_base(ar0, ar1, ai0, ai1)
        re = self._mul_base(*self.red(*s), *self.red(*d))
        ab = self.red(*self.mul_base(ar0, ar1, ai0, ai1))
        im0, c = self._addc(ab[0], ab[0])
        return re + (im0, (ab[1] * 2 + c) & M32)


# -- host-side pack/unpack ---------------------------------------------------

def m61_to_pairs(x: np.ndarray):
    x = np.asarray(x, dtype=np.uint64)
    return ((x & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (x >> np.uint64(32)).astype(np.uint32))


def m61_from_pairs(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
