// The view, modes and arguments of the length-L axis DFT down one axis of
// the (R1, R2, C) register, shared by axis_fft.cuh (the register-pass
// shift butterflies of K1, K2's two r2 launches, K3a, both K4 launches,
// K5, K9's four axis phases and the shift form of K4u / K5u), r2_split.cuh
// (the radix-5 r2 DFT) and k4u_pass.cu (the unfolded passes' int8 matrix
// form), with K1's prologue (ax_k1_inject_halve) and the unfolded passes'
// prologue and epilogue (ax_pass_pre, ax_pass_post).
//
// The array is viewed as (O, L, S, C): element (o, j, s, c) at
// ((o*L + j)*S + s)*C + c, the transform runs over j. A block (or one of
// K9's tiles) owns one (o, s) pair and a slab of AX_TC consecutive columns
// or more, so every global access is a run of AX_TC u64 words.
#pragma once

#include "gl64.cuh"

#define AX_TC 32
#define AX_TY 8
// a block's shared memory on Hopper (227 KB)
#define AX_SMEM_MAX 232448

enum AxisMode {
    AX_K1 = 0,   // carry inject + wrap halve, the r1 DFT per s (= r2)
    AX_K2A = 1,  // the r2 DFT, then x mf (P2: K2's first launch, K5)
    AX_K2C = 2,  // x mi first, the r2 inverse per o (= r1) (P6: K2's
                 // last launch, K5)
    AX_K3A = 3,  // the r1 inverse per s, then wrap double, canon,
                 // optional x a
    AX_K4F = 4,  // block-carry inject (when co is given) + wrap halve,
                 // then K1's transform
    AX_K4UF = 5, // K4u / K5u forward: ax_pass_pre, the DIF, ax_pass_post
    AX_K4UI = 6  // K4u / K5u inverse: the same around the inverse DIT
};

struct AxisArgs {
    const u64* x;
    u64* out;
    const u64* tab;      // K2A: mf, K2C: mi; same layout as x
    // K1: the previous step's carries (R*T,), one per carry unit of ct
    // digits (T = C / ct units per row), unrolled, and the per-unit spread
    // tables (R*T, kk). K4F: the carries (L,), one per r1 block, unrolled,
    // or null, and the per-block spread tables (L, kk)
    const u64* co;
    const u32* wt;
    const u32* cum;
    int kk;
    int ct;
    // K1 / K3A / K4F: wrap residues er (R,) and ec (C,)
    const u32* er;
    const u32* ec;
    u32 n;
    // K3A: small multiplier
    u64 a;
    int with_a;
    int O, L, S, C;
    // the column scales applied before the transform
    // (K1, K4F: k1_cs (L, S)) and the row scales after it (K1, K4F: k1_rs
    // (L, S); K2C: t_r_inv (O, L); K3A: k3_rs (L, S))
    const u64* cs;
    const u64* rs;
    // K4u / K5u (AX_K4UF, AX_K4UI and k4u_pass.cu's matrix form): pre and
    // post, full (as x) or one word per row (o, j, s) (pre_bcast,
    // post_bcast), or null; the scalar carry cin spread over the kk widths
    // at wt into digits 0 ... kk-1 of row 0 (kk = 0: none); the wrap
    // residues er (per row) and ec (C,), or null; canon: double where
    // wrapped, then reduce to [0, P) (without it, halve where wrapped
    // first)
    const u64* pre;
    const u64* post;
    int pre_bcast, post_bcast;
    u64 cin;
    int canon;
};

// Internal linkage: several .cu files instantiate the same modes.
namespace {

// K1's prologue of element (j, s, c) of the (1, L, S, C) view: the carry
// parts of its unit, then the halve where the weight wraps. Flat row f =
// r1*R2 + r2, carry unit u = f*T + c/ct; the roll by one unit (unit u
// takes unit u-1's carry, unit 0 the last one's) is folded in here.
__device__ __forceinline__ u64 ax_k1_inject_halve(const AxisArgs& g, int j,
                                                  int s, int c, u64 v) {
    const int T = g.C / g.ct;
    const int U = g.L * g.S * T;
    const int f = j * g.S + s;
    const int cl = c % g.ct;
    if (cl < g.kk) {
        const int u = f * T + c / g.ct;
        const u64 cin = g.co[(u + U - 1) % U];
        const u32 cm = g.cum[u * g.kk + cl];
        u32 part = cm < 64 ? (u32)(cin >> cm) : 0u;
        if (cl < g.kk - 1) part &= (1u << g.wt[u * g.kk + cl]) - 1u;
        v += part;
    }
    if (g.er[f] + g.ec[c] >= g.n) v = gl_halve(v);
    return v;
}

// K4u / K5u's prologue of element (o, j, s, c), in _pass_kernel's order
// (prmers_tpu/ops/pallas/kernels.py:130-226): halve where the weight
// wraps (not with canon), the carry's parts into digits 0 ... kk-1 of row
// 0 (the digits are canonical and the parts below 2^w, so the add cannot
// wrap), x pre.
__device__ __forceinline__ u64 ax_pass_pre(const AxisArgs& g, int o, int j,
                                           int s, int c, u64 v) {
    const size_t row = (size_t)(o * g.L + j) * g.S + s;
    if (!g.canon && g.er != nullptr && g.er[row] + g.ec[c] >= g.n)
        v = gl_halve(v);
    if (g.kk > 0 && row == 0 && c < g.kk) {
        int q = 0;
        for (int i = 0; i < c; ++i) q += (int)g.wt[i];
        u32 part = q < 64 ? (u32)(g.cin >> q) : 0u;
        if (c < g.kk - 1) part &= (1u << g.wt[c]) - 1u;
        v += part;
    }
    if (g.pre != nullptr)
        v = gl_mul(v, g.pre[g.pre_bcast ? row : row * g.C + c]);
    return v;
}

// Its epilogue of output (o, k, s, c): x post, then with canon the double
// where the row's weight wraps and the reduction to [0, P).
__device__ __forceinline__ u64 ax_pass_post(const AxisArgs& g, int o, int k,
                                            int s, int c, u64 v) {
    const size_t row = (size_t)(o * g.L + k) * g.S + s;
    if (g.post != nullptr)
        v = gl_mul(v, g.post[g.post_bcast ? row : row * g.C + c]);
    if (g.canon) {
        if (g.er != nullptr && g.er[row] + g.ec[c] >= g.n) v = gl_double(v);
        v = gl_canon(v);
    }
    return v;
}

}  // namespace
