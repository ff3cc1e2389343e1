// Length-L DFT down one axis of the (R1, R2, C) register, as a direct
// mod-P matrix product on a shared-memory tile: the four axis phases of
// the persistent K9 kernel (its K1, K2a, K2c and K3a stages, k9_chain.cu),
// which calls axis_dft_tile directly.
//
// No other launch comes here any more: K1, K2's two r2 launches, the two
// K5 passes at a power-of-two L2, K3's first launch (K3a) and both K4
// launches run axis_fft.cuh's register-pass shift butterflies on the
// factored tables (one or two products per digit), which share this
// header's view, modes, arguments and K1 prologue (ax_k1_inject_halve).
//
// The array is viewed as (O, L, S, C): element (o, j, s, c) at
// ((o*L + j)*S + s)*C + c, the transform runs over j. A tile owns one
// (o, s) pair and a slab of AX_TC consecutive columns, so every global
// access is a run of AX_TC u64 words. It stages the L x L matrix and the
// L x AX_TC input slab (after the mode's prologue) in shared memory, then
// each thread forms L/AX_TY outputs of one column: out[k] = sum_j M[k][j]
// x[j], the L full products summed in a 192-bit accumulator and reduced
// once. A tile that takes all L outputs reads and writes the same element
// set, so it may run in place (out == x).
//
// What bounds it on the H100: L mod-P products per digit (64 at L = 64)
// on the integer pipe, against 16 bytes of device traffic per digit; K9's
// tiles are the next to move onto axis_fft.cuh's form.
//
// The radix-5 r2 factors L = 5 * 2^b (n = 5 * 2^k) do not come here: K2
// and K5 take them to r2_split.cuh's 5 x 2^b split, and the r1 axis
// never exceeds 64.
#pragma once

#include "gl64.cuh"

#define AX_TC 32
#define AX_TY 8
// a block's shared memory on Hopper (227 KB)
#define AX_SMEM_MAX 232448

enum AxisMode {
    AX_K1 = 0,   // carry inject + wrap halve, matrix per s (= r2)
    AX_K2A = 1,  // single matrix, then x mf (P2: K2's first launch, K5)
    AX_K2C = 2,  // x mi first, matrix per o (= r1) (P6: K2's last, K5)
    AX_K3A = 3,  // matrix per s, then wrap double, canon, optional x a
    AX_K4F = 4   // block-carry inject (when co is given) + wrap halve,
                 // then K1's transform (axis_fft.cuh only)
};

struct AxisArgs {
    const u64* x;
    u64* out;
    const u64* mats;     // (V, L, L)
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
    // axis_fft.cuh only: the column scales applied before the transform
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

// One tile of the transform: the (o, s) pair, the slab of AX_TC columns
// starting at cb * AX_TC and the outputs k0 <= k < k1, on AX_TC * AX_TY
// threads (tid = ty * AX_TC + tx) and (L * L + L * AX_TC) u64 of shared
// memory at smem. A tile of part of the outputs reads all L inputs, so it runs
// in place only when it takes all of them (k0 = 0, k1 = L). It opens with
// a barrier, so a block may run one tile after another on the same buffer
// (the persistent K9 kernel does).
template <int MODE>
__device__ __forceinline__ void axis_dft_tile(const AxisArgs& g, int o, int s,
                                              int cb, int k0, int k1,
                                              u64* smem, int tid) {
    const int L = g.L, S = g.S, C = g.C;
    const int tx = tid % AX_TC, ty = tid / AX_TC;
    const int c = cb * AX_TC + tx;

    int var = 0;
    if (MODE == AX_K1 || MODE == AX_K3A) var = s;
    if (MODE == AX_K2C) var = o;
    const u64* M = g.mats + (size_t)var * L * L;
    u64* xs = smem + L * L;     // L * AX_TC
    __syncthreads();
    for (int i = tid; i < L * L; i += AX_TC * AX_TY) smem[i] = M[i];

    for (int j = ty; j < L; j += AX_TY) {
        const size_t idx = ((size_t)(o * L + j) * S + s) * C + c;
        u64 v = g.x[idx];
        if (MODE == AX_K1) v = ax_k1_inject_halve(g, j, s, c, v);
        if (MODE == AX_K2C) v = gl_mul(v, g.tab[idx]);
        xs[j * AX_TC + tx] = v;
    }
    __syncthreads();

    for (int k = k0 + ty; k < k1; k += AX_TY) {
        const u64* Mk = smem + k * L;
        GlAcc sum = gl_acc_zero();
        for (int j = 0; j < L; ++j)
            gl_acc_madd(sum, Mk[j], xs[j * AX_TC + tx]);
        u64 acc = gl_acc_reduce(sum);
        const size_t idx = ((size_t)(o * L + k) * S + s) * C + c;
        if (MODE == AX_K2A) acc = gl_mul(acc, g.tab[idx]);
        if (MODE == AX_K3A) {
            if (g.er[k * S + s] + g.ec[c] >= g.n) acc = gl_double(acc);
            acc = gl_canon(acc);
            if (g.with_a) acc = gl_canon(gl_mul(acc, g.a));
        }
        g.out[idx] = acc;
    }
}

}  // namespace
