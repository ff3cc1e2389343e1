// The C-transform of one (R, C) register row at a time, in shared memory:
// the row kernel of K2 (its middle launch), of K6 and of K6b, and K9's row
// phase (k9_chain.cuh), which at 2^19 runs the kernel's body
// (fused_c_row_group) on one group of rows after another and at 2^15 ...
// 2^18 the split form below (c_slot_r2_fwd), three grid phases of short
// chains on the same scales.
//
// The function (fourstep.fused_c_mats, the JAX's _fused_c_kernel :991 and
// _fused_c_invh_kernel :1117): per row of C = ca * 128 digits (ca = 2^lca
// <= 64), slot j holding digits j*128 ... j*128 + 127,
//   fwd: the lane DFT over the ca slots (fourstep.dft_lanes, DIF order:
//        slot j then holds frequency kl_j = bitrev(j)), then per slot the
//        right-side product with Mf[j];
//   op:  the dyadic square, or x u (the spectral multiplicand), or none;
//   inv: the mirror: the Mi[j] products, then the inverse lane DFT.
// K2 and K6 run fwd + op + inv, or fwd alone in mode "fwd" (the stored
// multiplicand, in the JAX spectral layout); K6b runs op + inv on what K6
// "fwd" wrote.
//
// The row kernel computes it factored, with one general product per
// digit each way (fourstep.fused_c_scales):
//   Mf[j] = diag(cs_f[j]) @ V,   Mi[j] = V^-1 @ diag(cs_i[j]),
// V the natural-order 128-point DFT by w = root_554(128). Every other
// multiplier is a power of two or, for odd powers of w = 2^25 (2^48 - 1),
// two shifts and a subtraction (gl64.cuh: gl_mul_w128pow):
//   1. the lane DFT as two register passes ca = N1 x N2 (fourstep.
//      lane_split: one pass up to ca = 16): the N1-point DIF down the top
//      bits of the slot index, the twiddle 2^(192/ca * lo * bitrev(i)),
//      the N2-point DIF, all shift butterflies (roots 2^(192/N));
//   2. x cs_f[j][l];
//   3. the 128-point DFT as 16 x 8 (fourstep.c_slot_schedule): pass A the
//      16-point DIF of v[t + 8m] (root 2^12), x w^(t bitrev4(m)); pass B
//      the 8-point DIF of 8 consecutive words (root 2^24), which leaves
//      frequency 16 bitrev3(q) + bitrev4(h) at position 8h + q;
//   4. the op, on pass B's registers (u read at that frequency); "fwd"
//      stores them there, in natural order;
//   5. the inverse: pass B's 8-point inverse DIT, x w^(-q bitrev4(h)),
//      pass A's 16-point inverse DIT, x cs_i, the lane DIT (N2, twiddle,
//      N1), each the mirror of its forward step (b 2^-e = -b 2^(96-e)).
// About 1 + log2(C)/2 products' worth per digit each way (fourstep.
// c_fft_products), against 2 (ca + 128) dense products before.
//
// The group steps (cf_*) and the row function c_row (the kernel's sweeps
// in its order on a plain array) are GL_FN, so a host compiler builds them
// with gl64.cuh (tests/test_torch_cfft.py holds them to the dense product
// at every C); the kernel is CUDA only.
//
// The kernel: a block holds ROWS rows (4 at C = 1024, 2 at 2048 when R
// fills the card, else 1) in shared memory once, in place: 64 KiB at C =
// 8192, three blocks per SM. Each pass is one sweep over the block's
// groups, registers in between (16 words in pass A and the lane passes at
// ca = 16, 8 elsewhere), a barrier after it: forward 3-4 sweeps (lane
// pass 1 reads device memory, [lane pass 2], pass A), then pass B + op +
// inverse pass B in one sweep, then inverse pass A, [lane pass 2], lane
// pass 1 writing device memory. The thread <-> group maps (lane passes:
// consecutive threads take consecutive lanes l; pass A: t fastest, then
// the slot; pass B: h fastest) and the swizzle cf_sw (word i of slot g at
// g*128 + (i ^ ((i >> 4) & 7) ^ 8 (g & 1))) keep every u64 shared access
// of a half-warp on 16 distinct bank pairs.
//
// What bounds it on the H100: the bytes (16 per digit, plus cs_f / cs_i
// from L2); the work per digit is ~13 shift butterflies, 1-2 shifted
// twiddles and a product each way. The kernel's time splits into moving
// the row and the arithmetic by two cut-down bodies (CF_NO_SLOT_LEVELS:
// everything but the 128-point butterflies; CF_MOVE: the same loads and
// stores with an add in place of every product, no DFT), which only the
// pass profiler launches (k6_fused_c.cu: prmers_fused_c_part).
#pragma once

#include "gl64.cuh"

enum { ROW_NONE = 0, ROW_SQR = 1, ROW_MUL = 2 };

// ---------------------------------------------------------------------------
// The factored C-transform's steps on one group of registers (host-callable)
// ---------------------------------------------------------------------------

// v[i s] *= 2^(step bitrev_LR(i)): the twiddle after the top pass of a
// four-step DIF (step = 192 / N * lo for the group lo).
template <int LR>
GL_FN void cf_tw_pow2_fwd(u64* v, int s, int step) {
#pragma unroll
    for (int i = 1; i < (1 << LR); ++i)
        v[i * s] = gl_mul_pow2(v[i * s], (step * gl_brev(i, LR)) % 192);
}

// v[i s] *= 2^(-step i): its mirror before the inverse top pass (step =
// 192 / N * bitrev(hi) for the group hi).
template <int LR>
GL_FN void cf_tw_pow2_inv(u64* v, int s, int step) {
#pragma unroll
    for (int i = 1; i < (1 << LR); ++i)
        v[i * s] = gl_mul_pow2(v[i * s], (192 - (step * i) % 192) % 192);
}

// v[i s] *= w^(f bitrev_LR(i)), w = root_554(128).
template <int LR>
GL_FN void cf_tw_w128_fwd(u64* v, int s, int f) {
#pragma unroll
    for (int i = 1; i < (1 << LR); ++i)
        v[i * s] = gl_mul_w128pow(v[i * s], f * gl_brev(i, LR));
}

// v[i s] *= w^(-step i).
template <int LR>
GL_FN void cf_tw_w128_inv(u64* v, int s, int step) {
#pragma unroll
    for (int i = 1; i < (1 << LR); ++i)
        v[i * s] = gl_mul_w128pow(v[i * s], -step * i);
}

// The lane DFT's register passes, ca = 2^(R1 + R2): pass 1 on the N1 =
// 2^R1 slots (i << R2) | lo of group lo, pass 2 on the N2 slots (hi << R2)
// | i of group hi. Forward: DIF (+ twiddle); inverse: the mirror, pass 2
// (twiddle after) first.
template <int R1, int R2>
GL_FN void cf_lane_fwd1(u64* v, int lo) {
    gl_dif_shift<R1>(v, 1);
    if (R2) cf_tw_pow2_fwd<R1>(v, 1, (192 >> (R1 + R2)) * lo);
}

template <int R1, int R2>
GL_FN void cf_lane_inv2(u64* v, int hi) {
    gl_dit_shift_inv<R2>(v, 1);
    cf_tw_pow2_inv<R2>(v, 1, (192 >> (R1 + R2)) * gl_brev(hi, R1));
}

// Pass A forward on group t of a slot: v[m] = word t + 8m (m < 16), x cs
// (cs points at the slot's scale word t), the 16-point DIF, x w^(t
// bitrev4(m)).
GL_FN void cf_slot_a_fwd(u64* v, int t, const u64* cs) {
#pragma unroll
    for (int m = 0; m < 16; ++m) v[m] = gl_mul(v[m], cs[8 * m]);
    gl_dif_shift<4>(v, 1);
    cf_tw_w128_fwd<4>(v, 1, t);
}

// Pass B inverse on group h: v[q] = word 8h + q (q < 8, holding frequency
// 16 bitrev3(q) + bitrev4(h)), the 8-point inverse DIT, x w^(-q
// bitrev4(h)).
GL_FN void cf_slot_b_inv(u64* v, int h) {
    gl_dit_shift_inv<3>(v, 1);
    cf_tw_w128_inv<3>(v, 1, gl_brev(h, 4));
}

// Pass A inverse on group t: the 16-point inverse DIT (word t + 8m in,
// digit t + 8m out), x cs.
GL_FN void cf_slot_a_inv(u64* v, const u64* cs) {
    gl_dit_shift_inv<4>(v, 1);
#pragma unroll
    for (int m = 0; m < 16; ++m) v[m] = gl_mul(v[m], cs[8 * m]);
}

// Word i of a slot in natural order <-> position bitrev7(i) after pass B.
GL_FN void cf_slot_bitrev(u64* x) {
    for (int i = 0; i < 128; ++i) {
        const int k = gl_brev(i, 7);
        if (i < k) {
            const u64 a = x[i];
            x[i] = x[k];
            x[k] = a;
        }
    }
}

// The row functions: one row x[0 .. C) in place, C = 128 << LCA, the
// kernel's sweeps in its order on a plain array. Forward: natural in,
// the spectral layout out; inverse: the mirror.
template <int LCA>
GL_FN void c_row_fwd_t(u64* x, const u64* cs) {
    constexpr int R1 = LCA <= 4 ? LCA : 3, R2 = LCA - R1;
    constexpr int CA = 1 << LCA;
    u64 v[16];
    for (int l = 0; l < 128; ++l)
        for (int lo = 0; lo < (1 << R2); ++lo) {
            for (int i = 0; i < (1 << R1); ++i)
                v[i] = x[(((i << R2) | lo) << 7) + l];
            cf_lane_fwd1<R1, R2>(v, lo);
            for (int i = 0; i < (1 << R1); ++i)
                x[(((i << R2) | lo) << 7) + l] = v[i];
        }
    for (int l = 0; l < 128; ++l)
        for (int hi = 0; hi < (1 << R1); ++hi) {
            for (int i = 0; i < (1 << R2); ++i)
                v[i] = x[(((hi << R2) | i) << 7) + l];
            gl_dif_shift<R2>(v, 1);
            for (int i = 0; i < (1 << R2); ++i)
                x[(((hi << R2) | i) << 7) + l] = v[i];
        }
    for (int j = 0; j < CA; ++j) {
        u64* sx = x + (j << 7);
        for (int t = 0; t < 8; ++t) {
            for (int m = 0; m < 16; ++m) v[m] = sx[t + 8 * m];
            cf_slot_a_fwd(v, t, cs + (j << 7) + t);
            for (int m = 0; m < 16; ++m) sx[t + 8 * m] = v[m];
        }
        for (int h = 0; h < 16; ++h) gl_dif_shift<3>(sx + 8 * h, 1);
        cf_slot_bitrev(sx);
    }
}

template <int LCA>
GL_FN void c_row_inv_t(u64* x, const u64* cs) {
    constexpr int R1 = LCA <= 4 ? LCA : 3, R2 = LCA - R1;
    constexpr int CA = 1 << LCA;
    u64 v[16];
    for (int j = 0; j < CA; ++j) {
        u64* sx = x + (j << 7);
        cf_slot_bitrev(sx);
        for (int h = 0; h < 16; ++h) cf_slot_b_inv(sx + 8 * h, h);
        for (int t = 0; t < 8; ++t) {
            for (int m = 0; m < 16; ++m) v[m] = sx[t + 8 * m];
            cf_slot_a_inv(v, cs + (j << 7) + t);
            for (int m = 0; m < 16; ++m) sx[t + 8 * m] = v[m];
        }
    }
    for (int l = 0; l < 128; ++l)
        for (int hi = 0; hi < (1 << R1); ++hi) {
            for (int i = 0; i < (1 << R2); ++i)
                v[i] = x[(((hi << R2) | i) << 7) + l];
            if (R2) cf_lane_inv2<R1, R2>(v, hi);
            for (int i = 0; i < (1 << R2); ++i)
                x[(((hi << R2) | i) << 7) + l] = v[i];
        }
    for (int l = 0; l < 128; ++l)
        for (int lo = 0; lo < (1 << R2); ++lo) {
            for (int i = 0; i < (1 << R1); ++i)
                v[i] = x[(((i << R2) | lo) << 7) + l];
            gl_dit_shift_inv<R1>(v, 1);
            for (int i = 0; i < (1 << R1); ++i)
                x[(((i << R2) | lo) << 7) + l] = v[i];
        }
}

// lca = log2(C / 128) in 1 ... 6; cs is cs_f (forward) or cs_i.
GL_FN void c_row(u64* x, int lca, const u64* cs, int inverse) {
#define CF_ROW_CASE(L)                                                   \
    case L:                                                              \
        if (inverse)                                                     \
            c_row_inv_t<L>(x, cs);                                       \
        else                                                             \
            c_row_fwd_t<L>(x, cs);                                       \
        break;
    switch (lca) {
        CF_ROW_CASE(1)
        CF_ROW_CASE(2)
        CF_ROW_CASE(3)
        CF_ROW_CASE(4)
        CF_ROW_CASE(5)
        CF_ROW_CASE(6)
        default:
            break;
    }
#undef CF_ROW_CASE
}

// ---------------------------------------------------------------------------
// The split form's slot DFT: radix-2 levels, four words a thread
// ---------------------------------------------------------------------------
// K9's split row phase (k9_chain.cuh at the shapes its rule picks) computes
// the same transform in three grid phases: the lane pass of one (row, lane)
// at a time (cf_lane_fwd1), every slot on its own warp, the inverse lane
// pass. A slot's 128-point DFT by w there is the seven radix-2 DIF levels
// m = 64 ... 1 (a + b and (a - b) w^(64 jj / m), natural in, position i
// holding frequency bitrev7(i) out, as passes A and B leave it), the
// inverse their mirror DIT by w^-1 (b w^(-64 jj / m), then a + b, a - b; no
// 1/128). A warp's thread k holds four words through four register passes:
// levels (64, 32), (16, 8) and (4, 2) on the words of cf_r2_word<MLO> for
// MLO = 32, 8, 2, then level 1 (MLO = 0), the square and the inverse back.
// A thread's chain is 14 butterflies each way (two a level) and a product
// at each end, against pass A's 16 products, 32 butterflies and 15
// twiddles, then pass B's 12 butterflies, in the group.

// Word c (< 4) of thread k (< 32) in the pass of levels 2 MLO and MLO:
// 4 MLO (k / MLO) + k % MLO + MLO c; MLO = 0, level 1: 2k + (c & 1) +
// 64 (c >> 1).
template <int MLO>
GL_FN int cf_r2_word(int k, int c) {
    if constexpr (MLO == 0)
        return 2 * k + (c & 1) + 64 * (c >> 1);
    else
        return 4 * MLO * (k / MLO) + k % MLO + MLO * c;
}

// Level 1's butterflies, pairs (0, 1) and (2, 3), twiddle 1: their own
// inverse but for the factor 2.
GL_FN void cf_r2_level1(u64* v) {
#pragma unroll
    for (int c = 0; c < 4; c += 2) {
        const u64 a = v[c], b = v[c + 1];
        v[c] = gl_add(a, b);
        v[c + 1] = gl_sub(a, b);
    }
}

// The DIF levels 2 MLO (pairs c, c + 2: jj = k % MLO + MLO c) and MLO
// (pairs c, c + 1: jj = k % MLO) on thread k's words; MLO = 0: level 1.
template <int MLO>
GL_FN void cf_r2_fwd(u64* v, int k) {
    if constexpr (MLO == 0) {
        cf_r2_level1(v);
    } else {
        const int r = k % MLO;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const u64 a = v[c], b = v[c + 2];
            v[c] = gl_add(a, b);
            v[c + 2] = gl_mul_w128pow(gl_sub(a, b), (r + MLO * c) * (32 / MLO));
        }
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
            const u64 a = v[c], b = v[c + 1];
            v[c] = gl_add(a, b);
            v[c + 1] = gl_mul_w128pow(gl_sub(a, b), r * (64 / MLO));
        }
    }
}

// Its mirror: the DIT levels MLO, then 2 MLO, by w^-1.
template <int MLO>
GL_FN void cf_r2_inv(u64* v, int k) {
    if constexpr (MLO == 0) {
        cf_r2_level1(v);
    } else {
        const int r = k % MLO;
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
            const u64 a = v[c], b = gl_mul_w128pow(v[c + 1], -r * (64 / MLO));
            v[c] = gl_add(a, b);
            v[c + 1] = gl_sub(a, b);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const u64 a = v[c];
            const u64 b = gl_mul_w128pow(v[c + 2], -(r + MLO * c) * (32 / MLO));
            v[c] = gl_add(a, b);
            v[c + 2] = gl_sub(a, b);
        }
    }
}

// The slot functions on a plain array of 128 words, the kernel's passes in
// its order: forward x cs then the DIF (bit-reversed out); inverse the DIT
// (bit-reversed in) then x cs.
template <int MLO>
GL_FN void cf_r2_sweep(u64* s, int inverse) {
    for (int k = 0; k < 32; ++k) {
        u64 v[4];
        for (int c = 0; c < 4; ++c) v[c] = s[cf_r2_word<MLO>(k, c)];
        if (inverse)
            cf_r2_inv<MLO>(v, k);
        else
            cf_r2_fwd<MLO>(v, k);
        for (int c = 0; c < 4; ++c) s[cf_r2_word<MLO>(k, c)] = v[c];
    }
}

GL_FN void c_slot_r2_fwd(u64* s, const u64* cs) {
    for (int i = 0; i < 128; ++i) s[i] = gl_mul(s[i], cs[i]);
    cf_r2_sweep<32>(s, 0);
    cf_r2_sweep<8>(s, 0);
    cf_r2_sweep<2>(s, 0);
    cf_r2_sweep<0>(s, 0);
}

GL_FN void c_slot_r2_inv(u64* s, const u64* cs) {
    cf_r2_sweep<0>(s, 1);
    cf_r2_sweep<2>(s, 1);
    cf_r2_sweep<8>(s, 1);
    cf_r2_sweep<32>(s, 1);
    for (int i = 0; i < 128; ++i) s[i] = gl_mul(s[i], cs[i]);
}

// One row of the split form (ca <= 16: one lane pass), mode 0 forward
// (the lane DIF, then each slot's, the spectrum in natural order as
// c_row's), 1 inverse (the mirror), 2 the squaring row of K9's three
// phases (the lane DIF; per slot the DIF, the square where it leaves the
// spectrum, the DIT; the lane DIT). cs is cs_f (modes 0, 2) or cs_i (1);
// ci cs_i in mode 2.
template <int LCA>
GL_FN void c_row_split_t(u64* x, const u64* cs, const u64* ci, int mode) {
    static_assert(LCA <= 4, "the split form's lane pass is one pass");
    constexpr int CA = 1 << LCA;
    u64 v[CA];
    if (mode != 1)
        for (int l = 0; l < 128; ++l) {
            for (int i = 0; i < CA; ++i) v[i] = x[(i << 7) + l];
            cf_lane_fwd1<LCA, 0>(v, 0);
            for (int i = 0; i < CA; ++i) x[(i << 7) + l] = v[i];
        }
    for (int j = 0; j < CA; ++j) {
        u64* sx = x + (j << 7);
        if (mode != 1) c_slot_r2_fwd(sx, cs + (j << 7));
        if (mode == 2)
            for (int i = 0; i < 128; ++i) sx[i] = gl_sqr(sx[i]);
        if (mode != 2) cf_slot_bitrev(sx);
        if (mode != 0) c_slot_r2_inv(sx, (mode == 2 ? ci : cs) + (j << 7));
    }
    if (mode != 0)
        for (int l = 0; l < 128; ++l) {
            for (int i = 0; i < CA; ++i) v[i] = x[(i << 7) + l];
            gl_dit_shift_inv<LCA>(v, 1);
            for (int i = 0; i < CA; ++i) x[(i << 7) + l] = v[i];
        }
}

// lca in 1 ... 4.
GL_FN void c_row_split(u64* x, int lca, const u64* cs, const u64* ci,
                       int mode) {
    switch (lca) {
        case 1: c_row_split_t<1>(x, cs, ci, mode); break;
        case 2: c_row_split_t<2>(x, cs, ci, mode); break;
        case 3: c_row_split_t<3>(x, cs, ci, mode); break;
        case 4: c_row_split_t<4>(x, cs, ci, mode); break;
        default: break;
    }
}

#if defined(__CUDACC__)

#include <cuda_runtime.h>

// The row kernel's body: the whole transform, or a cut-down one for the
// pass profiler (see above); only CF_FULL computes the transform.
enum { CF_FULL = 0, CF_NO_SLOT_LEVELS = 1, CF_MOVE = 2 };

// Internal linkage: K2, K6 and K9 all instantiate the row body.
namespace {

// The shared-memory word of element i of the block's slot g.
__device__ __forceinline__ int cf_sw(int g, int i) {
    return (g << 7) | (i ^ ((i >> 4) & 7) ^ ((g & 1) << 3));
}

template <int LCA, int ROWS>
struct CfShape {
    static constexpr int CA = 1 << LCA;
    static constexpr int C = CA << 7;
    static constexpr int NS = ROWS * CA;          // slots per block
    static constexpr int E = ROWS * C;            // words per block
    static constexpr int NT = E / 8 < 256 ? E / 8 : 256;
    static constexpr int R1 = LCA <= 4 ? LCA : 3;
    static constexpr int R2 = LCA - R1;
};

// The transform of one group of ROWS rows (group grp: rows grp * ROWS
// ...), on threads tid < NT of the block and E words of shared memory at
// sm; every thread of the block calls it (its barriers are the block's).
// It reads every word of its rows before it writes one, so it runs in
// place; it opens with a sweep that writes sm, so a caller that runs one
// group after another separates them by a barrier (K9 does, k9_chain.cuh;
// the kernel below runs one group per block).
template <int LCA, int ROWS, int PART>
__device__ __forceinline__ void fused_c_row_group(
    const u64* x, u64* out, const u64* u, int fwd, int op, int inv,
    const u64* __restrict__ cs_f, const u64* __restrict__ cs_i, int grp,
    u64* sm, int tid) {
    using S = CfShape<LCA, ROWS>;
    constexpr int CA = S::CA, NS = S::NS, NT = S::NT;
    constexpr int R1 = S::R1, R2 = S::R2, N1 = 1 << R1, N2 = 1 << R2;
    constexpr bool FULL = PART == CF_FULL, MOVE = PART == CF_MOVE;
    const size_t base = (size_t)grp * S::E;
    const u64* xb = x + base;
    u64* ob = out + base;
    const u64* ub = u ? u + base : nullptr;

    if (fwd) {
        // lane pass 1: device memory -> registers -> shared memory
        for (int q = tid; q < ROWS * N2 * 128; q += NT) {
            const int l = q & 127, lo = (q >> 7) & (N2 - 1);
            const int g0 = (q >> (7 + R2)) * CA + lo;
            u64 v[N1];
#pragma unroll
            for (int i = 0; i < N1; ++i) v[i] = xb[((g0 + (i << R2)) << 7) + l];
            if (!MOVE) cf_lane_fwd1<R1, R2>(v, lo);
#pragma unroll
            for (int i = 0; i < N1; ++i) sm[cf_sw(g0 + (i << R2), l)] = v[i];
        }
        __syncthreads();
        if constexpr (R2 > 0) {
            for (int q = tid; q < ROWS * N1 * 128; q += NT) {
                const int l = q & 127;
                const int g0 = (q >> (7 + R1)) * CA +
                               (((q >> 7) & (N1 - 1)) << R2);
                u64 v[N2];
#pragma unroll
                for (int i = 0; i < N2; ++i) v[i] = sm[cf_sw(g0 + i, l)];
                if (!MOVE) gl_dif_shift<R2>(v, 1);
#pragma unroll
                for (int i = 0; i < N2; ++i) sm[cf_sw(g0 + i, l)] = v[i];
            }
            __syncthreads();
        }
        // pass A
        for (int q = tid; q < NS * 8; q += NT) {
            const int t = q & 7, g = q >> 3;
            const u64* cs = cs_f + ((g & (CA - 1)) << 7) + t;
            u64 v[16];
#pragma unroll
            for (int m = 0; m < 16; ++m) v[m] = sm[cf_sw(g, t + 8 * m)];
            if (FULL) {
                cf_slot_a_fwd(v, t, cs);
            } else {
#pragma unroll
                for (int m = 0; m < 16; ++m)
                    v[m] = MOVE ? gl_add(v[m], cs[8 * m])
                                : gl_mul(v[m], cs[8 * m]);
                if (!MOVE) cf_tw_w128_fwd<4>(v, 1, t);
            }
#pragma unroll
            for (int m = 0; m < 16; ++m) sm[cf_sw(g, t + 8 * m)] = v[m];
        }
        __syncthreads();
    }

    // pass B, the op, inverse pass B (or the store of "fwd")
    for (int q = tid; q < NS * 16; q += NT) {
        const int h = q & 15, g = q >> 4;
        const int bh = gl_brev(h, 4);
        u64 v[8];
        if (fwd) {
#pragma unroll
            for (int m = 0; m < 8; ++m) v[m] = sm[cf_sw(g, 8 * h + m)];
            if (FULL) gl_dif_shift<3>(v, 1);
        } else {
#pragma unroll
            for (int m = 0; m < 8; ++m)
                v[m] = xb[(g << 7) + (gl_brev(m, 3) << 4) + bh];
        }
        if (op == ROW_SQR) {
#pragma unroll
            for (int m = 0; m < 8; ++m)
                v[m] = MOVE ? gl_add(v[m], v[m]) : gl_sqr(v[m]);
        } else if (op == ROW_MUL) {
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                const u64 w = ub[(g << 7) + (gl_brev(m, 3) << 4) + bh];
                v[m] = MOVE ? gl_add(v[m], w) : gl_mul(v[m], w);
            }
        }
        if (!inv) {
#pragma unroll
            for (int m = 0; m < 8; ++m)
                ob[(g << 7) + (gl_brev(m, 3) << 4) + bh] = v[m];
            continue;
        }
        if (FULL)
            cf_slot_b_inv(v, h);
        else if (!MOVE)
            cf_tw_w128_inv<3>(v, 1, bh);
#pragma unroll
        for (int m = 0; m < 8; ++m) sm[cf_sw(g, 8 * h + m)] = v[m];
    }
    if (!inv) return;
    __syncthreads();

    // inverse pass A
    for (int q = tid; q < NS * 8; q += NT) {
        const int t = q & 7, g = q >> 3;
        const u64* cs = cs_i + ((g & (CA - 1)) << 7) + t;
        u64 v[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) v[m] = sm[cf_sw(g, t + 8 * m)];
        if (FULL) {
            cf_slot_a_inv(v, cs);
        } else {
#pragma unroll
            for (int m = 0; m < 16; ++m)
                v[m] = MOVE ? gl_add(v[m], cs[8 * m]) : gl_mul(v[m], cs[8 * m]);
        }
#pragma unroll
        for (int m = 0; m < 16; ++m) sm[cf_sw(g, t + 8 * m)] = v[m];
    }
    __syncthreads();
    if constexpr (R2 > 0) {
        for (int q = tid; q < ROWS * N1 * 128; q += NT) {
            const int l = q & 127, hi = (q >> 7) & (N1 - 1);
            const int g0 = (q >> (7 + R1)) * CA + (hi << R2);
            u64 v[N2];
#pragma unroll
            for (int i = 0; i < N2; ++i) v[i] = sm[cf_sw(g0 + i, l)];
            if (!MOVE) cf_lane_inv2<R1, R2>(v, hi);
#pragma unroll
            for (int i = 0; i < N2; ++i) sm[cf_sw(g0 + i, l)] = v[i];
        }
        __syncthreads();
    }
    // inverse lane pass 1: shared memory -> registers -> device memory
    for (int q = tid; q < ROWS * N2 * 128; q += NT) {
        const int l = q & 127, lo = (q >> 7) & (N2 - 1);
        const int g0 = (q >> (7 + R2)) * CA + lo;
        u64 v[N1];
#pragma unroll
        for (int i = 0; i < N1; ++i) v[i] = sm[cf_sw(g0 + (i << R2), l)];
        if (!MOVE) gl_dit_shift_inv<R1>(v, 1);
#pragma unroll
        for (int i = 0; i < N1; ++i) ob[((g0 + (i << R2)) << 7) + l] = v[i];
    }
}

// The split form's three bodies (see c_slot_r2_fwd above), each over one
// item of its grid phase, in place on x; a phase's items touch disjoint
// words. With R2S (K9 at L2 = 1, where K2's r2 passes are elementwise)
// the lane passes also take them: x mf as the lane DIF loads a word, x mi
// and x t_r_inv[row] as the lane DIT stores one.

// The lane DIF of lane l of row `row` (its CA words, stride 128).
template <int LCA, int PART, bool R2S>
__device__ __forceinline__ void cf_lane_item_fwd(u64* x, int row, int l,
                                                 const u64* __restrict__ mf) {
    constexpr int CA = 1 << LCA;
    constexpr bool MOVE = PART == CF_MOVE;
    const size_t base = (size_t)row * (CA << 7) + l;
    u64 v[CA];
#pragma unroll
    for (int i = 0; i < CA; ++i) {
        v[i] = x[base + (i << 7)];
        if constexpr (R2S)
            v[i] = MOVE ? gl_add(v[i], mf[base + (i << 7)])
                        : gl_mul(v[i], mf[base + (i << 7)]);
    }
    if (!MOVE) cf_lane_fwd1<LCA, 0>(v, 0);
#pragma unroll
    for (int i = 0; i < CA; ++i) x[base + (i << 7)] = v[i];
}

// Its mirror, the lane DIT.
template <int LCA, int PART, bool R2S>
__device__ __forceinline__ void cf_lane_item_inv(
    u64* x, int row, int l, const u64* __restrict__ mi,
    const u64* __restrict__ t_r_inv) {
    constexpr int CA = 1 << LCA;
    constexpr bool MOVE = PART == CF_MOVE;
    const size_t base = (size_t)row * (CA << 7) + l;
    u64 v[CA];
#pragma unroll
    for (int i = 0; i < CA; ++i) v[i] = x[base + (i << 7)];
    if (!MOVE) gl_dit_shift_inv<LCA>(v, 1);
#pragma unroll
    for (int i = 0; i < CA; ++i) {
        if constexpr (R2S) {
            const u64 f = mi[base + (i << 7)], t = t_r_inv[row];
            v[i] = MOVE ? gl_add(gl_add(v[i], f), t)
                        : gl_mul(gl_mul(v[i], f), t);
        }
        x[base + (i << 7)] = v[i];
    }
}

// A slot's word w in the warp's shared memory: conflict-free for every
// pass's half-warp.
__device__ __forceinline__ int cf_r2_sw(int w) { return w ^ ((w >> 2) & 15); }

// Thread k's words from pass A's layout to pass B's, through sm; each
// thread writes only the words it next reads, so one warp barrier orders
// the exchange.
template <int A, int B>
__device__ __forceinline__ void cf_r2_swap(u64* v, u64* sm, int k) {
#pragma unroll
    for (int c = 0; c < 4; ++c) sm[cf_r2_sw(cf_r2_word<A>(k, c))] = v[c];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = sm[cf_r2_sw(cf_r2_word<B>(k, c))];
}

// One slot of 128 words at xs, in place, on the 32 threads of a warp
// (lane k) and 128 words of shared memory at sm that no other warp
// touches: x cs_f, the DIF, the square, the DIT, x cs_i (cs_f, cs_i the
// slot's scales).
template <int PART>
__device__ __forceinline__ void cf_slot_r2_sqr(u64* xs,
                                               const u64* __restrict__ cs_f,
                                               const u64* __restrict__ cs_i,
                                               u64* sm, int k) {
    constexpr bool MOVE = PART == CF_MOVE;
    u64 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int w = k + 32 * c;
        v[c] = MOVE ? gl_add(xs[w], cs_f[w]) : gl_mul(xs[w], cs_f[w]);
    }
    if (!MOVE) cf_r2_fwd<32>(v, k);
    cf_r2_swap<32, 8>(v, sm, k);
    if (!MOVE) cf_r2_fwd<8>(v, k);
    cf_r2_swap<8, 2>(v, sm, k);
    if (!MOVE) cf_r2_fwd<2>(v, k);
    cf_r2_swap<2, 0>(v, sm, k);
    if (!MOVE) cf_r2_level1(v);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = MOVE ? gl_add(v[c], v[c]) : gl_sqr(v[c]);
    if (!MOVE) cf_r2_level1(v);
    cf_r2_swap<0, 2>(v, sm, k);
    if (!MOVE) cf_r2_inv<2>(v, k);
    cf_r2_swap<2, 8>(v, sm, k);
    if (!MOVE) cf_r2_inv<8>(v, k);
    cf_r2_swap<8, 32>(v, sm, k);
    if (!MOVE) cf_r2_inv<32>(v, k);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int w = k + 32 * c;
        xs[w] = MOVE ? gl_add(v[c], cs_i[w]) : gl_mul(v[c], cs_i[w]);
    }
}

template <int LCA, int ROWS, int PART>
__global__ void __launch_bounds__(256)
fused_c_row_kernel(const u64* x, u64* out, const u64* u, int fwd, int op,
                   int inv, const u64* __restrict__ cs_f,
                   const u64* __restrict__ cs_i) {
    extern __shared__ u64 sm[];
    fused_c_row_group<LCA, ROWS, PART>(x, out, u, fwd, op, inv, cs_f, cs_i,
                                       blockIdx.x, sm, threadIdx.x);
}

template <int LCA, int ROWS, int PART>
int cf_launch(const u64* x, u64* out, const u64* u, int fwd, int op,
              int inv, const u64* cs_f, const u64* cs_i, int R,
              cudaStream_t stream) {
    using S = CfShape<LCA, ROWS>;
    if (R % ROWS) return -1;
    const int smem = S::E * (int)sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(
        fused_c_row_kernel<LCA, ROWS, PART>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_c_row_kernel<LCA, ROWS, PART><<<R / ROWS, S::NT, smem, stream>>>(
        x, out, u, fwd, op, inv, cs_f, cs_i);
    return (int)cudaGetLastError();
}

// Rows per block: as many as fill 4096 words (up to 4) when R fills the
// card (R >= 2048), one otherwise, and always at C >= 4096.
template <int LCA, int PART>
int cf_rows(const u64* x, u64* out, const u64* u, int fwd, int op, int inv,
            const u64* cs_f, const u64* cs_i, int R, cudaStream_t st) {
    constexpr int C = 128 << LCA;
    constexpr int RMAX = 4096 / C > 4 ? 4 : (4096 / C < 1 ? 1 : 4096 / C);
    if constexpr (RMAX > 1) {
        if (R >= 2048)
            return cf_launch<LCA, RMAX, PART>(x, out, u, fwd, op, inv, cs_f,
                                              cs_i, R, st);
    }
    return cf_launch<LCA, 1, PART>(x, out, u, fwd, op, inv, cs_f, cs_i, R,
                                   st);
}

}  // namespace

// The row kernel over all R rows of a (R, C) register; may run in place
// (out == x: each block reads its rows before it writes them, and u may
// be any other buffer). Returns cudaGetLastError(), or -1 for a C the
// kernel does not take (C = 128 * 2^lca, 1 <= lca <= 6).
template <int PART = CF_FULL>
static int fused_c_rows(const u64* x, u64* out, const u64* u, int fwd,
                        int op, int inv, const u64* cs_f, const u64* cs_i,
                        int R, int C, cudaStream_t st) {
    switch (C) {
        case 256:
            return cf_rows<1, PART>(x, out, u, fwd, op, inv, cs_f, cs_i, R, st);
        case 512:
            return cf_rows<2, PART>(x, out, u, fwd, op, inv, cs_f, cs_i, R, st);
        case 1024:
            return cf_rows<3, PART>(x, out, u, fwd, op, inv, cs_f, cs_i, R, st);
        case 2048:
            return cf_rows<4, PART>(x, out, u, fwd, op, inv, cs_f, cs_i, R, st);
        case 4096:
            return cf_rows<5, PART>(x, out, u, fwd, op, inv, cs_f, cs_i, R, st);
        case 8192:
            return cf_rows<6, PART>(x, out, u, fwd, op, inv, cs_f, cs_i, R, st);
        default:
            return -1;
    }
}

#endif  // __CUDACC__
