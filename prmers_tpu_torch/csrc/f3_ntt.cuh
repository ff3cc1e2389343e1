// The second arithmetic's transform (fft3161): the per-thread bodies of
// K10 (a forward stage), K11 (an inverse stage) and K12 (the pointwise
// product), host-callable so that a host compiler can check them against
// the plain versions (tests/test_torch_ntt2.py). csrc/f3_ntt.cu launches
// them.
//
// The JAX package computes this path in XLA ops, with no Pallas kernel
// (prmers_tpu/ops/ntt2.py: plane_fwd :264-289, plane_inv :291-317,
// forward_3161 :320-332, inverse_3161 :334-356, Fq2Ops.sqr/mul of
// core/field2.py). Every value here is canonical (< q) in and out, as in
// the reference's Fq2Ops, so each stage's output equals the plain
// version's word for word: an M31 component is one u32, an M61 one u64,
// and each plane is stored (2, n) (re, then im). A product is the native
// 32 x 32 -> 64 (M31) or 64 x 64 -> 128 (M61, __umul64hi) multiply,
// folded with 2^s = 1 by mers.cuh, then canonicalized.
//
// A stage of radix r at length L = r m over B blocks maps element (b, k,
// j) to itself: one thread owns the r values b L + k m + j (k < r) of both
// planes, loads them, runs the butterfly and the twiddles, and stores them
// in place. The butterflies are the reference's _bfly: radix 2 and 4 with
// units only (the w4 term w d = +-i d by the root family's sign), radix 3
// Winograd's with one general product by root_unity(3) or its inverse.
#pragma once

#include "mers.cuh"

#if defined(__CUDACC__)
#define F3_FN __host__ __device__ __forceinline__
#else
#define F3_FN inline
#endif

struct F31 {
    typedef u32 T;
    static constexpr u32 Q = M31_P;
    F3_FN static T add(T a, T b) {
        const T r = a + b;
        return r >= Q ? r - Q : r;
    }
    F3_FN static T sub(T a, T b) { return a >= b ? a - b : a + Q - b; }
    F3_FN static T mul(T a, T b) { return m31_canon(m31_mul_r(a, b)); }
    // a u64 word (a digit) to [0, q)
    F3_FN static T norm(u64 x) {
        x = (x & Q) + (x >> 31);
        x = (x & Q) + (x >> 31);
        return (T)(x >= Q ? x - Q : x);
    }
};

struct F61 {
    typedef u64 T;
    static constexpr u64 Q = M61_P;
    F3_FN static T add(T a, T b) {
        const T r = a + b;
        return r >= Q ? r - Q : r;
    }
    F3_FN static T sub(T a, T b) { return a >= b ? a - b : a + Q - b; }
    F3_FN static T mul(T a, T b) { return m61_canon(m61_mul_r(a, b)); }
    F3_FN static T norm(u64 x) {
        x = (x & Q) + (x >> 61);
        return x >= Q ? x - Q : x;
    }
};

template <class F>
struct Cx {
    typename F::T re, im;
};

template <class F>
F3_FN Cx<F> cx_add(Cx<F> a, Cx<F> b) {
    return {F::add(a.re, b.re), F::add(a.im, b.im)};
}

template <class F>
F3_FN Cx<F> cx_sub(Cx<F> a, Cx<F> b) {
    return {F::sub(a.re, b.re), F::sub(a.im, b.im)};
}

template <class F>
F3_FN Cx<F> cx_mul(Cx<F> a, Cx<F> b) {
    return {F::sub(F::mul(a.re, b.re), F::mul(a.im, b.im)),
            F::add(F::mul(a.re, b.im), F::mul(a.im, b.re))};
}

template <class F>
F3_FN Cx<F> cx_sqr(Cx<F> a) {
    return {F::sub(F::mul(a.re, a.re), F::mul(a.im, a.im)),
            F::mul(F::add(a.re, a.re), a.im)};
}

// One plane's arguments for a stage: x its (2, n) words; tw the stage's
// (2, r, m) twiddles (forward) or inverse twiddles; w the (2, n) weights
// (the first forward stage) or unweights (the last inverse stage), else
// null; w3 the radix-3 root of the direction; neg4 whether the radix-4
// term is -(i d) in this direction (the reference's
// _w4_is_i(q) == inverse).
template <class F>
struct PlaneArgs {
    typename F::T* x;
    const typename F::T* tw;
    const typename F::T* w;
    typename F::T w3r, w3i;
    int neg4;
};

// A stage: radix r, m = L / r, B blocks, n words per plane; d the digits
// (the first forward stage) and lo, hi the CRT output (the last inverse
// stage), else null; crt = q31^-1 mod q61.
struct StageArgs {
    int r, m, B, n;
    const u64* d;
    u64* lo;
    u64* hi;
    u64 crt;
    PlaneArgs<F31> p31;
    PlaneArgs<F61> p61;
};

F3_FN StageArgs f3_stage_args(u32* x31, u64* x61, const u32* tw31,
                              const u64* tw61, const u32* w31,
                              const u64* w61, int r, int m, int B, int n,
                              const u64* d, u64* lo, u64* hi, u64 crt,
                              u32 w3r31, u32 w3i31, u64 w3r61, u64 w3i61,
                              int neg4_31, int neg4_61) {
    StageArgs s;
    s.r = r;
    s.m = m;
    s.B = B;
    s.n = n;
    s.d = d;
    s.lo = lo;
    s.hi = hi;
    s.crt = crt;
    s.p31 = {x31, tw31, w31, w3r31, w3i31, neg4_31};
    s.p61 = {x61, tw61, w61, w3r61, w3i61, neg4_61};
    return s;
}

template <class F, int R>
F3_FN void f3_bfly(Cx<F>* v, const PlaneArgs<F>& a) {
    if (R == 2) {
        const Cx<F> x0 = v[0], x1 = v[1];
        v[0] = cx_add<F>(x0, x1);
        v[1] = cx_sub<F>(x0, x1);
    } else if (R == 3) {
        const Cx<F> x0 = v[0], x1 = v[1], x2 = v[2];
        const Cx<F> w3 = {a.w3r, a.w3i};
        const Cx<F> t = cx_mul<F>(w3, cx_sub<F>(x1, x2));
        v[0] = cx_add<F>(x0, cx_add<F>(x1, x2));
        v[1] = cx_add<F>(cx_sub<F>(x0, x2), t);
        v[2] = cx_sub<F>(cx_sub<F>(x0, x1), t);
    } else {
        const Cx<F> a0 = cx_add<F>(v[0], v[2]), b0 = cx_sub<F>(v[0], v[2]);
        const Cx<F> c0 = cx_add<F>(v[1], v[3]), d0 = cx_sub<F>(v[1], v[3]);
        // i d = (-im, re); its negation (im, -re)
        Cx<F> wd = {F::sub(0, d0.im), d0.re};
        if (a.neg4) wd = {d0.im, F::sub(0, d0.re)};
        v[0] = cx_add<F>(a0, c0);
        v[1] = cx_add<F>(b0, wd);
        v[2] = cx_sub<F>(a0, c0);
        v[3] = cx_sub<F>(b0, wd);
    }
}

// v[k] *= tw[k][j] for k >= 1 (row 0 of a stage's twiddles is ones)
template <class F, int R>
F3_FN void f3_twiddle(Cx<F>* v, const PlaneArgs<F>& a, int j, int m) {
    for (int k = 1; k < R; ++k)
        v[k] = cx_mul<F>(v[k], {a.tw[k * m + j], a.tw[(R + k) * m + j]});
}

template <class F, int R>
F3_FN void f3_store(const PlaneArgs<F>& a, const Cx<F>* v, long base, int m,
                    long n) {
    for (int k = 0; k < R; ++k) {
        a.x[base + (long)k * m] = v[k].re;
        a.x[n + base + (long)k * m] = v[k].im;
    }
}

// K10 on one plane: [norm(d) x weights,] the DIF butterfly, x tw
template <class F, int R>
F3_FN void f3_fwd_plane(const PlaneArgs<F>& a, const u64* d, long base,
                        int j, int m, long n) {
    Cx<F> v[R];
    for (int k = 0; k < R; ++k) {
        const long i = base + (long)k * m;
        if (d) {
            const typename F::T q = F::norm(d[i]);
            v[k] = {F::mul(a.w[i], q), F::mul(a.w[n + i], q)};
        } else {
            v[k] = {a.x[i], a.x[n + i]};
        }
    }
    f3_bfly<F, R>(v, a);
    f3_twiddle<F, R>(v, a, j, m);
    f3_store<F, R>(a, v, base, m, n);
}

// K11 on one plane: x twi, then the DIT butterfly (left in v)
template <class F, int R>
F3_FN void f3_inv_plane(const PlaneArgs<F>& a, Cx<F>* v, long base, int j,
                        int m, long n) {
    for (int k = 0; k < R; ++k) {
        const long i = base + (long)k * m;
        v[k] = {a.x[i], a.x[n + i]};
    }
    f3_twiddle<F, R>(v, a, j, m);
    f3_bfly<F, R>(v, a);
}

// v = c31 + q31 tmul, tmul = (c61 - c31) q31^-1 mod q61 (< 2^92), as
// (lo, hi) u64 words
F3_FN void f3_crt(u32 c31, u64 c61, u64 crt, u64& lo, u64& hi) {
    const u64 t = F61::mul(F61::sub(c61, (u64)c31), crt);
    const u64 p = t * (u64)M31_P;
    lo = p + c31;
    hi = gl_mulhi(t, (u64)M31_P) + (lo < p ? 1ULL : 0ULL);
}

template <int R>
F3_FN void f3_fwd_item(const StageArgs& s, long t) {
    const long b = t / s.m;
    const int j = (int)(t - b * s.m);
    const long base = b * R * s.m + j;
    f3_fwd_plane<F31, R>(s.p31, s.d, base, j, s.m, s.n);
    f3_fwd_plane<F61, R>(s.p61, s.d, base, j, s.m, s.n);
}

// K11: both planes; the last stage (lo set) folds the unweights, takes
// the real part and writes the CRT's (lo, hi) instead of the planes
template <int R>
F3_FN void f3_inv_item(const StageArgs& s, long t) {
    const long b = t / s.m;
    const int j = (int)(t - b * s.m);
    const long base = b * R * s.m + j, n = s.n;
    Cx<F31> u[R];
    Cx<F61> v[R];
    f3_inv_plane<F31, R>(s.p31, u, base, j, s.m, n);
    f3_inv_plane<F61, R>(s.p61, v, base, j, s.m, n);
    if (!s.lo) {
        f3_store<F31, R>(s.p31, u, base, s.m, n);
        f3_store<F61, R>(s.p61, v, base, s.m, n);
        return;
    }
    const u32* w31 = s.p31.w;
    const u64* w61 = s.p61.w;
    for (int k = 0; k < R; ++k) {
        const long i = base + (long)k * s.m;
        const u32 c31 = F31::sub(F31::mul(w31[i], u[k].re),
                                 F31::mul(w31[n + i], u[k].im));
        const u64 c61 = F61::sub(F61::mul(w61[i], v[k].re),
                                 F61::mul(w61[n + i], v[k].im));
        f3_crt(c31, c61, s.crt, s.lo[i], s.hi[i]);
    }
}

// K12 at word i of both planes: squared, or times the multiplicand m
F3_FN void f3_pointwise_item(u32* x31, u64* x61, const u32* m31,
                             const u64* m61, long n, long i) {
    const Cx<F31> a = {x31[i], x31[n + i]};
    const Cx<F61> b = {x61[i], x61[n + i]};
    const Cx<F31> ya = m31 ? cx_mul<F31>(a, {m31[i], m31[n + i]})
                           : cx_sqr<F31>(a);
    const Cx<F61> yb = m61 ? cx_mul<F61>(b, {m61[i], m61[n + i]})
                           : cx_sqr<F61>(b);
    x31[i] = ya.re;
    x31[n + i] = ya.im;
    x61[i] = yb.re;
    x61[n + i] = yb.im;
}
