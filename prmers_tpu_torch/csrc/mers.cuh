// GF(M31^2) and GF(M61^2) complex arithmetic as device functions: the
// operations of prmers_tpu/ops/pallas/mers.py (and of the port's
// ops/mers.py), the field ops of the second arithmetic path ("fft3161").
//
// The TPU's vector unit has 32-bit lanes with 16-bit multipliers, so the
// JAX module assembles every product from 16-bit pieces and carries an M61
// value as a (lo, hi) pair of u32 words. Hopper multiplies 32 x 32 -> 64
// and 64 x 64 -> 128 bits natively (__umul64hi), so here an M31 component
// is one u32 and an M61 component one u64, with the same lazy bounds and
// the same integer values step for step (an M61 pair (lo, hi) is the u64
// lo + hi * 2^32):
//   * M31: lazy < 2^32, red(x) = (x & M31) + (x >> 31) < 2^31 + 1;
//   * M61: lazy < 2^62, red(x) = (x & M61) + (x >> 61) < 2^61 + 8.
// Complex mul is the schoolbook 4 base muls on M31 and Karatsuba's 3 on
// M61, squaring (a + b)(a - b) + 2ab i (2 base muls), as in the original.
#pragma once

#include "gl64.cuh"

#define M31_P 0x7FFFFFFFu
#define M61_P 0x1FFFFFFFFFFFFFFFULL

GL_FN u32 m31_red(u32 x) { return (x & M31_P) + (x >> 31); }

GL_FN u32 m31_canon(u32 x) {
    const u32 r = m31_red(m31_red(x));
    return r >= M31_P ? r - M31_P : r;
}

// reduced inputs (< 2^31 + 1): (p & M31) + (p >> 31) < 2^32, lazy
GL_FN u32 m31_mul_r(u32 a, u32 b) {
    const u64 p = (u64)a * b;
    return (u32)(p & M31_P) + (u32)(p >> 31);
}

GL_FN u32 m31_add(u32 a, u32 b) {
    return m31_red(m31_red(a)) + m31_red(m31_red(b));
}

GL_FN u32 m31_sub(u32 a, u32 b) {
    return (M31_P + m31_red(m31_red(a))) - m31_red(b);
}

GL_FN void m31c_mul(u32 ar, u32 ai, u32 br, u32 bi, u32& re, u32& im) {
    const u32 rr = m31_red(ar), ri = m31_red(ai);
    const u32 sr = m31_red(br), si = m31_red(bi);
    const u32 t1 = m31_mul_r(rr, sr), t2 = m31_mul_r(ri, si);
    const u32 t3 = m31_mul_r(rr, si), t4 = m31_mul_r(ri, sr);
    re = m31_sub(t1, t2);
    im = m31_add(t3, t4);
}

GL_FN void m31c_sqr(u32 ar, u32 ai, u32& re, u32& im) {
    const u32 rr = m31_red(ar), ri = m31_red(ai);
    const u32 s = rr + ri;                 // u32 sums wrap as the original's
    const u32 d = (M31_P + rr) - ri;
    const u32 ab = m31_mul_r(rr, ri);
    re = m31_mul_r(m31_red(s), m31_red(d));
    im = m31_red(m31_red(ab)) * 2u;
}

GL_FN u64 m61_red(u64 x) { return (x & M61_P) + (x >> 61); }

GL_FN u64 m61_canon(u64 x) {
    const u64 r = m61_red(m61_red(x));
    return r >= M61_P ? r - M61_P : r;
}

// reduced inputs (< 2^61 + 8): p < 2^123, (p & M61) + (p >> 61) < 2^63
GL_FN u64 m61_mul_r(u64 a, u64 b) {
    const u64 lo = a * b, hi = gl_mulhi(a, b);
    return (lo & M61_P) + ((lo >> 61) | (hi << 3));
}

GL_FN u64 m61_mul(u64 a, u64 b) { return m61_mul_r(m61_red(a), m61_red(b)); }

GL_FN u64 m61_add(u64 a, u64 b) { return m61_red(a) + m61_red(b); }

// red(a) + 2 * M61 - red(b) < 2^63, folded once
GL_FN u64 m61_sub(u64 a, u64 b) {
    const u64 d = m61_red(a) + 2 * M61_P - m61_red(b);
    return (d & M61_P) + (d >> 61);
}

GL_FN void m61c_mul(u64 ar, u64 ai, u64 br, u64 bi, u64& re, u64& im) {
    const u64 t1 = m61_mul(ar, br), t2 = m61_mul(ai, bi);
    const u64 t3 = m61_mul_r(m61_red(m61_add(ar, ai)),
                             m61_red(m61_add(br, bi)));
    re = m61_sub(t1, t2);
    im = m61_sub(m61_sub(t3, t1), t2);
}

GL_FN void m61c_sqr(u64 ar, u64 ai, u64& re, u64& im) {
    const u64 s = m61_add(ar, ai), d = m61_sub(ar, ai);
    re = m61_mul_r(m61_red(s), m61_red(d));
    im = 2 * m61_red(m61_mul(ar, ai));
}
