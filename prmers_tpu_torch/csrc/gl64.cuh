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
