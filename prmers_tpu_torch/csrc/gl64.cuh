// Goldilocks GF(P) arithmetic on native u64, P = 2^64 - 2^32 + 1.
//
// Device counterpart of prmers_tpu/ops/pallas/gl64.py (:136-327), which
// carries every value as a pair of u32 words because the TPU's vector unit
// has no 64-bit lanes. Hopper's integer pipe has 64-bit adds and a 64x64
// high product (__umul64hi), so values are plain u64 here and the
// Solinas identities do the reduction: 2^64 = 2^32 - 1 (EPS) and
// 2^96 = -1 (mod P).
//
// Values are lazy: any v < 2^64 in the right residue class is accepted and
// produced; gl_canon reduces to [0, P). The functions are also host-callable
// (with unsigned __int128 for the high product) so the header can be
// checked against big-int arithmetic by a host compiler.
#pragma once

#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

#if defined(__CUDACC__)
#define GL_FN __host__ __device__ __forceinline__
#else
#define GL_FN static inline
#endif

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL

GL_FN u64 gl_mulhi(u64 a, u64 b) {
#if defined(__CUDA_ARCH__)
    return __umul64hi(a, b);
#else
    return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// a + b: a wrap past 2^64 is worth EPS; a second wrap is possible only when
// both inputs are lazy values near 2^64, and cannot happen a third time.
GL_FN u64 gl_add(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a) {
        u64 t = s + GL_EPS;
        if (t < s) t += GL_EPS;
        s = t;
    }
    return s;
}

// a - b: a borrow of 2^64 is worth -EPS; likewise at most twice.
GL_FN u64 gl_sub(u64 a, u64 b) {
    u64 d = a - b;
    if (a < b) {
        u64 t = d - GL_EPS;
        if (d < GL_EPS) t -= GL_EPS;
        d = t;
    }
    return d;
}

// (hi:lo) mod P: lo + hl*2^64 + hh*2^96 = lo + hl*EPS - hh.
GL_FN u64 gl_reduce128(u64 lo, u64 hi) {
    u64 hh = hi >> 32;
    u64 hl = hi & GL_EPS;
    u64 t0 = lo - hh;
    if (lo < hh) t0 -= GL_EPS;
    u64 t1 = hl * GL_EPS;
    u64 r = t0 + t1;
    if (r < t0) r += GL_EPS;
    return r;
}

GL_FN u64 gl_mul(u64 a, u64 b) {
    return gl_reduce128(a * b, gl_mulhi(a, b));
}

GL_FN u64 gl_sqr(u64 a) { return gl_mul(a, a); }

GL_FN u64 gl_mul_small(u64 a, u32 s) { return gl_mul(a, (u64)s); }

// a * 2^e for e in [0, 96): a 128-bit shift reduced, twice past 2^63.
GL_FN u64 gl_shiftmul(u64 a, int e) {
    if (e >= 48) {
        a = gl_reduce128(a << 48, a >> 16);
        e -= 48;
    }
    if (e == 0) return a;
    return gl_reduce128(a << e, a >> (64 - e));
}

// a * 2^s for s in [0, 192) (ord(2) = 192): past 96 the negated shift,
// since 2^96 = -1.
GL_FN u64 gl_mul_pow2(u64 a, int s) {
    if (s < 96) return gl_shiftmul(a, s);
    return gl_sub(0ULL, gl_shiftmul(a, s - 96));
}

// a * w^e with w = root_554(128), e any int (taken mod 128). w is no power
// of two (128 does not divide 192), but w^2 = 2^3 and w = 2^73 - 2^25 =
// 2^25 (2^48 - 1): an even power 2f is the shift 2^(3f), an odd one 2f + 1
// the shift 2^(3f + 25) times 2^48 - 1, one more shift and a subtraction.
GL_FN u64 gl_mul_w128pow(u64 a, int e) {
    e &= 127;
    if (!(e & 1)) return gl_mul_pow2(a, 3 * (e >> 1));
    const u64 v = gl_mul_pow2(a, (3 * (e >> 1) + 25) % 192);
    return gl_sub(gl_shiftmul(v, 48), v);
}

// bits-bit reversal of v (constant-folded where v and bits are).
GL_FN int gl_brev(int v, int bits) {
    int f = 0;
    for (int i = 0; i < bits; ++i) f |= ((v >> i) & 1) << (bits - 1 - i);
    return f;
}

// The R = 2^LR point DFT (R <= 64) of v[0], v[s], ..., v[(R - 1) s] in
// place by root_554(R) = 2^(192 / R): radix-2 DIF butterflies a + b and
// (a - b) 2^e, e = 192 / (2m) * jj at half-size m (fourstep.
// shift_exponents); natural in, bit-reversed out.
template <int LR>
GL_FN void gl_dif_shift(u64* v, int s) {
#pragma unroll
    for (int lm = LR - 1; lm >= 0; --lm) {
        const int m = 1 << lm;
#pragma unroll
        for (int q = 0; q < (1 << LR) / 2; ++q) {
            const int jj = q & (m - 1);
            const int ia = ((q >> lm) << (lm + 1)) + jj;
            const u64 a = v[ia * s], b = v[(ia + m) * s];
            v[ia * s] = gl_add(a, b);
            v[(ia + m) * s] = gl_shiftmul(gl_sub(a, b), (192 >> (lm + 1)) * jj);
        }
    }
}

// Its inverse mirror (no 1/R): radix-2 DIT butterflies by the inverse
// root, bit-reversed in, natural out. b 2^-e = -b 2^(96 - e), so with t =
// b 2^(96 - e) the butterfly is a - t and a + t (e = 0: a + b, a - b).
template <int LR>
GL_FN void gl_dit_shift_inv(u64* v, int s) {
#pragma unroll
    for (int lm = 0; lm < LR; ++lm) {
        const int m = 1 << lm;
#pragma unroll
        for (int q = 0; q < (1 << LR) / 2; ++q) {
            const int jj = q & (m - 1);
            const int ia = ((q >> lm) << (lm + 1)) + jj;
            const int e = (192 >> (lm + 1)) * jj;
            const u64 a = v[ia * s], b = v[(ia + m) * s];
            if (e == 0) {
                v[ia * s] = gl_add(a, b);
                v[(ia + m) * s] = gl_sub(a, b);
            } else {
                const u64 t = gl_shiftmul(b, 96 - e);
                v[ia * s] = gl_sub(a, t);
                v[(ia + m) * s] = gl_add(a, t);
            }
        }
    }
}

// a / 2: (a >> 1) + lsb * (P + 1) / 2, which cannot wrap.
GL_FN u64 gl_halve(u64 a) {
    return (a >> 1) + ((a & 1ULL) ? 0x7FFFFFFF80000001ULL : 0ULL);
}

GL_FN u64 gl_double(u64 a) { return gl_add(a, a); }

GL_FN u64 gl_canon(u64 a) { return a >= GL_P ? a - GL_P : a; }

// A dot product sum_j a_j * b_j mod P with one reduction at the end: the
// full 128-bit products add into a 192-bit (top:hi:lo) accumulator. Each
// product is < 2^128, so up to 2^32 of them fit (top counts the carries
// out of hi); the kernels sum at most 128.
struct GlAcc {
    u64 lo, hi, top;
};

GL_FN GlAcc gl_acc_zero() {
    GlAcc z = {0ULL, 0ULL, 0ULL};
    return z;
}

GL_FN void gl_acc_madd(GlAcc& s, u64 a, u64 b) {
    const u64 plo = a * b;
    const u64 phi = gl_mulhi(a, b);   // <= 2^64 - 2: phi + 1 cannot wrap
    s.lo += plo;
    const u64 t = phi + (s.lo < plo ? 1ULL : 0ULL);
    s.hi += t;
    s.top += (s.hi < t) ? 1ULL : 0ULL;
}

// lo + hi*2^64 + top*2^128 with 2^128 = -2^32 (mod P), lazy out.
GL_FN u64 gl_acc_reduce(const GlAcc& s) {
    return gl_sub(gl_reduce128(s.lo, s.hi), s.top << 32);
}
