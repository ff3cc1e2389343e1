// The view, modes and arguments of the length-L axis DFT down one axis of
// the (R1, R2, C) register, shared by axis_fft.cuh (the register-pass
// shift butterflies of K1, K2's two r2 launches, K3a, both K4 launches,
// K5 and K9's four axis phases), r2_split.cuh (the radix-5 r2 DFT) and
// k4u_pass.cu (the unfolded passes), with K1's prologue
// (ax_k1_inject_halve).
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
    AX_K4F = 4   // block-carry inject (when co is given) + wrap halve,
                 // then K1's transform
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

}  // namespace
