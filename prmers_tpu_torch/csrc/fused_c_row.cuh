// The C-transform of one (R, C) register row at a time, in shared memory:
// the row kernel of K2 (its middle launch), of K6 and of K6b; and K9's
// dense form of it, split by slot (row_slot_unit, then row_lane_dft).
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
//
// K9 (csrc/k9_chain.cu) keeps its dense form: row_slot_unit and
// row_lane_dft below, on the tables lane_f, lane_i, Mf, Mi.
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

#if defined(__CUDACC__)

#include <cuda_runtime.h>

// The row kernel's body: the whole transform, or a cut-down one for the
// pass profiler (see above); only CF_FULL computes the transform.
enum { CF_FULL = 0, CF_NO_SLOT_LEVELS = 1, CF_MOVE = 2 };

// Internal linkage: K2 and K6 both instantiate the row kernel.
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

template <int LCA, int ROWS, int PART>
__global__ void __launch_bounds__(256)
fused_c_row_kernel(const u64* x, u64* out, const u64* u, int fwd, int op,
                   int inv, const u64* __restrict__ cs_f,
                   const u64* __restrict__ cs_i) {
    using S = CfShape<LCA, ROWS>;
    constexpr int CA = S::CA, NS = S::NS, NT = S::NT;
    constexpr int R1 = S::R1, R2 = S::R2, N1 = 1 << R1, N2 = 1 << R2;
    constexpr bool FULL = PART == CF_FULL, MOVE = PART == CF_MOVE;
    extern __shared__ u64 sm[];
    const size_t base = (size_t)blockIdx.x * S::E;
    const u64* xb = x + base;
    u64* ob = out + base;
    const u64* ub = u ? u + base : nullptr;
    const int tid = threadIdx.x;

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

// K9's form, dense: dst[r][q*128 + l] = sum_p D[q][p] * src[r][p*128 + l]
__device__ __forceinline__ void row_lane_dft(const u64* src, u64* dst,
                                             const u64* D, int rows, int C,
                                             int ca) {
    const int tot = rows * C;
    for (int idx = threadIdx.x; idx < tot; idx += blockDim.x) {
        const int r = idx / C;
        const int rem = idx - r * C;
        const int q = rem >> 7;
        const int l = rem & 127;
        const u64* srow = src + r * C + l;
        const u64* Dq = D + q * ca;
        GlAcc sum = gl_acc_zero();
        for (int p = 0; p < ca; ++p) gl_acc_madd(sum, Dq[p], srow[p * 128]);
        dst[idx] = gl_acc_reduce(sum);
    }
}

// K9's form of the row C-transform with the square, split so that the ca
// slots of a row run in ca blocks: unit (rows r0 ... r0 + G - 1, slot j)
// forms slot j of each row's forward lane DFT, the Mf[j] slot product, the
// square and the Mi[j] slot product, and writes that slot of the mirror to
// S (the inverse lane DFT still to come: row_lane_dft from S finishes each
// row). Each matrix word read serves G rows. On 256 threads (tid < 256)
// and 3 * G * 128 u64 of shared memory at smem; the two groups of 128
// threads each sum half of a slot product. It opens with a barrier, so a
// block may run one unit after another on the same buffer.
template <int G>
__device__ __forceinline__ void row_slot_unit(const u64* x, u64* S,
                                              const u64* lane_f,
                                              const u64* __restrict__ Mf,
                                              const u64* __restrict__ Mi,
                                              int C, int ca, int r0, int j,
                                              u64* smem, int tid) {
    u64* V = smem;              // G x 128: the slot's values
    u64* P = smem + G * 128;    // 2 x G x 128: the halves of a product
    const int k = tid & 127;
    const int h = tid >> 7;
    __syncthreads();
    for (int i = tid; i < G * 128; i += 256) {
        const u64* xr = x + (size_t)(r0 + (i >> 7)) * C + (i & 127);
        GlAcc sum = gl_acc_zero();
        for (int p = 0; p < ca; ++p)
            gl_acc_madd(sum, lane_f[j * ca + p], xr[p * 128]);
        V[i] = gl_acc_reduce(sum);
    }
    for (int pass = 0; pass < 2; ++pass) {
        const u64* Mj = (pass ? Mi : Mf) + (size_t)j * 128 * 128 + k;
        __syncthreads();
        GlAcc acc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = gl_acc_zero();
        for (int l = 64 * h; l < 64 * h + 64; ++l) {
            const u64 m = Mj[l * 128];
#pragma unroll
            for (int g = 0; g < G; ++g) gl_acc_madd(acc[g], V[g * 128 + l], m);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
            P[(h * G + g) * 128 + k] = gl_acc_reduce(acc[g]);
        __syncthreads();
        for (int i = tid; i < G * 128; i += 256) {
            const u64 v = gl_add(P[i], P[G * 128 + i]);
            if (pass)
                S[(size_t)(r0 + (i >> 7)) * C + j * 128 + (i & 127)] = v;
            else
                V[i] = gl_sqr(v);
        }
    }
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
