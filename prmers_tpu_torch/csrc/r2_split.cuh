// The radix-5 r2 DFT (L2 = 5 * 2^b, b <= 6) as a 5 x 2^b Cooley-Tukey
// split: K2's two r2 launches (K2a, K2c) and the two K5 passes at the
// radix-5 plans (n = 5 * 2^k).
//
// Replaces, at L2 = 5 * 2^b, the dense product by the natural-order
// Vandermonde matrix (mxu_dft.dft_matrix, prmers_tpu/ops/pallas/
// mxu_dft.py:53-67) that the Pallas axis-1 pass applies (_pass_kernel :130
// through _axis1_pass's pallas_call :452, from _p2_pass / _p6_pass
// :1574-1594, and the r2fold stages of _fused_c_kernel :991). The same
// functions, exact mod P, natural order in and out:
//   AX_K2A  out[o,k,c] = mf[o,k,c] * sum_j w^(k j) x[o,j,c]
//   AX_K2C  out[o,k,c] = t_r_inv[o,k] * sum_j w^(-k j) (mi x)[o,j,c]
// with w = root_554(L2) (the dense form folds t_r_inv into one matrix per
// r1, tri; here it is an (R1, L2) table applied to each output).
//
// With M = 2^b, j = j1 M + j2 and k = k1 + 5 k2 (j1, k1 < 5; j2, k2 < M):
//   w^(k j) = W5^(k1 j1) * w^(k1 j2) * WM^(k2 j2),
// W5 = w^M = root_554(5) and WM = w^5 = root_554(M) = 2^(192/M), since
// ord(2) = 192. So the transform is
//   1. per j2, the 5-point DFT of x[j1 M + j2] (a 5 x 5 matrix whose row
//      and column 0 are ones: 16 general products per 5 values);
//   2. the twiddle w^(+-k1 j2) (one product per value, none at j2 = 0);
//   3. per k1, the M-point DFT over j2: b levels of radix-2 DIF
//      butterflies with shift twiddles, a + b and (a - b) 2^e, e =
//      192/(2m) * jj at half-size m (fourstep.shift_exponents); the
//      inverse root takes 2^-e = 2^(192 - e) = -2^(96 - e), so its
//      butterfly is a + b and (b - a) 2^(96 - e). The cascade leaves k2 at
//      position p = bitrev_b(k2);
//   4. the store: position (k1, p) goes to row k1 + 5 bitrev_b(p), times
//      mf (K2A) or t_r_inv (K2C).
// About 5-6 products per digit (16/5, 4/5, the epilogue, mi for K2C) and
// b/2 shifted reductions, against L2 + 1 for the dense product.
//
// The per-column arithmetic (r5_dft5, r5_twiddle, r5_level, r5_row) is
// GL_FN on a (pointer, stride) column, so a host compiler builds it with
// gl64.cuh (tests/test_torch_r5split.py holds it to the dense product at
// every L2). The kernel is CUDA only.
//
// The kernel: a block owns one r1 (o) and a slab of R5_TC = 16 columns
// (16 x 16 threads). It stages the 5 x 5 matrix, the L2 twiddles and the
// shift exponents in shared memory; each thread then reads five inputs of
// one (j2, column) from device memory (x mi for K2C), runs steps 1 and 2
// in registers and writes the five values to the L2 x 16 slab in shared
// memory (40 KB at L2 = 320: five blocks per SM; a half-warp's row is one
// 128-byte line; 16 measured 4-21% faster than 32 and 64 columns on the
// H100, PERF.md); the b butterfly levels run on the slab, a barrier after
// each, as csrc/k4u_pass.cu's shift form does; the epilogue reads the slab
// in position order and writes rows of 16 consecutive words. Every input
// of a block is read before its first store, so the kernel runs in place
// (out == x), as K2's three launches need.
//
// What bounds it on the H100: the bytes, 24 per digit (x in, x out, mf or
// mi); a few products per digit is far below the integer pipe's rate. It
// reads about a third of that bound. Its time splits into moving the slab
// and the arithmetic by two cut-down bodies (R5_NO_LEVELS: steps 1, 2 and
// 4 without the butterflies; R5_MOVE: the same loads and stores with an
// add in place of every product, no DFT), which only the pass profiler
// launches (tools/profile_passes.py --r5; PERF.md has the split).
#pragma once

#include "gl64.cuh"

// Butterfly of a DIF level: a + b and (a - b) 2^e, or with inverse (the
// conjugate root) (b - a) 2^(96 - e) = (a - b) 2^-e; e = 0 is the twiddle 1
// either way. e < 96.
GL_FN void r5_butterfly(u64& a, u64& b, int e, int inverse) {
    const u64 x = a, y = b;
    a = gl_add(x, y);
    if (e == 0)
        b = gl_sub(x, y);
    else if (inverse)
        b = gl_shiftmul(gl_sub(y, x), 96 - e);
    else
        b = gl_shiftmul(gl_sub(x, y), e);
}

// The 5-point DFT in place on v[0], v[s], ..., v[4s] by the row-major 5 x
// 5 matrix m (m[5k + j] = W5^(k j)); its row and column 0 are ones and are
// not read: y0 = sum x, yk = x0 + sum_{j >= 1} m[5k + j] x_j, the four
// products summed in a 192-bit accumulator and reduced once.
GL_FN void r5_dft5(u64* v, int s, const u64* m) {
    u64 x[5], y[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) x[j] = v[j * s];
    y[0] = gl_add(gl_add(gl_add(x[0], x[1]), gl_add(x[2], x[3])), x[4]);
#pragma unroll
    for (int k = 1; k < 5; ++k) {
        GlAcc a = gl_acc_zero();
#pragma unroll
        for (int j = 1; j < 5; ++j) gl_acc_madd(a, m[5 * k + j], x[j]);
        y[k] = gl_add(gl_acc_reduce(a), x[0]);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k * s] = y[k];
}

// The twiddle step of one j2: v[k s] *= tw[k ts] for k = 1 ... 4, where
// tw points at the twiddle table's word j2 and ts = M (the table holds
// w^(+-k1 j2) at k1 M + j2; row k1 = 0 is ones and is not read).
GL_FN void r5_twiddle(u64* v, int s, const u64* tw, int ts) {
#pragma unroll
    for (int k = 1; k < 5; ++k) v[k * s] = gl_mul(v[k * s], tw[k * ts]);
}

// One DIF level of half-size m = 2^lm on the five M-point sub-columns (M =
// 2^b, b >= 1) of an L2-column v (value i at v[i s], sub-column k1 at rows
// k1 M ... k1 M + M - 1): butterflies q = q0, q0 + dq, ... below 5 M / 2,
// with the level's exponents e[jj], jj < m (the shift-exponent table at
// offset M - 2m). All index arithmetic is shifts and masks.
GL_FN void r5_level(u64* v, int s, int b, int lm, const int* e, int inverse,
                    int q0, int dq) {
    const int hb = b - 1, m = 1 << lm;
    for (int q = q0; q < (5 << hb); q += dq) {
        const int qq = q & ((1 << hb) - 1);
        const int jj = qq & (m - 1);
        const int ia = ((q >> hb) << b) + ((qq >> lm) << (lm + 1)) + jj;
        r5_butterfly(v[(long)ia * s], v[(long)(ia + m) * s], e[jj], inverse);
    }
}

// The output row of slab position r = k1 M + p: k1 + 5 bitrev_b(p).
GL_FN int r5_row(int r, int b) {
    const int p = r & ((1 << b) - 1);
#if defined(__CUDA_ARCH__)
    const int f = b ? (int)(__brev((unsigned)p) >> (32 - b)) : 0;
#else
    int f = 0;
    for (int i = 0; i < b; ++i) f |= ((p >> i) & 1) << (b - 1 - i);
#endif
    return (r >> b) + 5 * f;
}

#if defined(__CUDACC__)

#include "axis_dft.cuh"

struct R5Args {
    const u64* x;
    u64* out;
    const u64* tab;    // K2A: mf (after), K2C: mi (before); layout of x
    const u64* d5;     // (5, 5) forward or inverse 5-point matrix
    const u64* tw;     // (L2,) twiddles w^(+-k1 j2) at k1 M + j2
    const int* ex;     // (M - 1,) shift exponents, level m at M - 2m
    const u64* trs;    // K2C: t_r_inv (R1, L2)
    int O, L, C;
};

// The kernel's body: the whole split, or a cut-down one for the pass
// profiler (see above); only R5_FULL computes the transform.
enum { R5_FULL = 0, R5_NO_LEVELS = 1, R5_MOVE = 2 };
#define R5_TC 16                  // columns per block
#define R5_TY (256 / R5_TC)       // rows of threads

namespace {

template <int MODE, int PART>
__global__ void __launch_bounds__(256) r2_split_kernel(R5Args g) {
    constexpr bool INV = MODE == AX_K2C;
    constexpr bool MOVE = PART == R5_MOVE;
    extern __shared__ u64 r5_smem[];
    const int L = g.L, C = g.C, M = L / 5;
    const int b = 31 - __clz(M);
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * R5_TC + tx;
    const int o = blockIdx.y;
    const int c = blockIdx.x * R5_TC + tx;
    u64* xs = r5_smem;                    // L * R5_TC
    u64* d5 = xs + L * R5_TC;             // 25
    u64* tw = d5 + 25;                    // L
    int* ex = (int*)(tw + L);             // M - 1
    for (int i = tid; i < 25; i += 256) d5[i] = g.d5[i];
    for (int i = tid; i < L; i += 256) tw[i] = g.tw[i];
    for (int i = tid; i < M - 1; i += 256) ex[i] = g.ex[i];
    __syncthreads();

    // steps 1 and 2 in registers, one (j2, column) per thread and turn
    const size_t base = (size_t)o * L * C + c;
    for (int j2 = ty; j2 < M; j2 += R5_TY) {
        u64 v[5];
#pragma unroll
        for (int j1 = 0; j1 < 5; ++j1) {
            const size_t idx = base + (size_t)(j1 * M + j2) * C;
            v[j1] = !INV ? g.x[idx]
                    : MOVE ? gl_add(g.x[idx], g.tab[idx])
                           : gl_mul(g.x[idx], g.tab[idx]);
        }
        if (!MOVE) {
            r5_dft5(v, 1, d5);
            if (j2) r5_twiddle(v, 1, tw + j2, M);
        }
#pragma unroll
        for (int k1 = 0; k1 < 5; ++k1)
            xs[(k1 * M + j2) * R5_TC + tx] = v[k1];
    }
    __syncthreads();

    // step 3: the b butterfly levels on the slab
    if (PART == R5_FULL) {
        for (int lm = b - 1; lm >= 0; --lm) {
            r5_level(xs + tx, R5_TC, b, lm, ex + (M - (2 << lm)), INV, ty,
                     R5_TY);
            __syncthreads();
        }
    }

    // step 4: natural-order rows, x mf or x t_r_inv
    for (int r = ty; r < L; r += R5_TY) {
        const int k = r5_row(r, b);
        const size_t idx = base + (size_t)k * C;
        const u64 v = xs[r * R5_TC + tx];
        const u64 f = INV ? g.trs[o * L + k] : g.tab[idx];
        g.out[idx] = MOVE ? gl_add(v, f) : gl_mul(v, f);
    }
}

}  // namespace

// One split pass over the whole (R1, L2, C) register; returns
// cudaGetLastError(), or -1 for a shape the kernel does not take (L2 not
// 5 * 2^b with 2^b | 64, C not a multiple of R5_TC).
template <int MODE, int PART = R5_FULL>
static int r2_split_launch(const R5Args& g, cudaStream_t stream) {
    const int M = g.L / 5;
    if (g.L % 5 || M < 1 || M > 64 || (M & (M - 1)) || g.C % R5_TC)
        return -1;
    const size_t smem = ((size_t)g.L * R5_TC + 25 + g.L) * sizeof(u64) +
                        (size_t)M * sizeof(int);
    if (smem > AX_SMEM_MAX) return -1;
    cudaError_t err = cudaFuncSetAttribute(
        r2_split_kernel<MODE, PART>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(g.C / R5_TC, g.O);
    dim3 block(R5_TC, R5_TY);
    r2_split_kernel<MODE, PART><<<grid, block, smem, stream>>>(g);
    return (int)cudaGetLastError();
}

#endif  // __CUDACC__
