// The C-transform of one (R, C) register row at a time, in shared memory:
// the row kernel of K2 (its middle launch), of K6 and of K6b; and K9's
// form of it, split by slot (row_slot_unit, then row_lane_dft).
//
// For each row it runs, as the launch asks,
//   fwd: the lane-tile DFT over ca = c >> 7 (fourstep.dft_lanes :447),
//        then per ca slot j one 128x128 right-side product with Mf[j]
//        (out[b, k] = sum_l x[b, l] * M[l, k]);
//   op:  the dyadic square, or x u (the spectral multiplicand), or none;
//   inv: the mirror: the Mi[j] slot products, then the inverse lane DFT.
// K2 and K6 run fwd + op + inv, or fwd alone in mode "fwd" (the stored
// multiplicand, in the JAX spectral layout); K6b runs op + inv on what K6
// "fwd" wrote. A block holds ROWS rows twice (the two working copies) and
// the ca x ca lane matrix: at C = 8192, one row, 160 KiB. The slot
// matrices (ca x 128 x 128 u64: 8 MiB per direction at ca = 64) stream
// from L2; each matrix word is reused for all the block's rows. Every dot
// product adds full 128-bit products into a 192-bit accumulator and
// reduces once.
#pragma once

#include <cuda_runtime.h>

#include "gl64.cuh"

enum { ROW_NONE = 0, ROW_SQR = 1, ROW_MUL = 2 };

// Internal linkage: K2 and K6 both instantiate the row kernel.
namespace {

// dst[r][q*128 + l] = sum_p D[q][p] * src[r][p*128 + l]
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

// dst[r][j*128 + k] = sum_l src[r][j*128 + l] * M[j][l][k]
template <int ROWS>
__device__ __forceinline__ void row_slot_mat(const u64* src, u64* dst,
                                             const u64* __restrict__ M,
                                             int C, int ca) {
    const int k = threadIdx.x & 127;
    const int grp = threadIdx.x >> 7;
    const int ngrp = blockDim.x >> 7;
    for (int j = grp; j < ca; j += ngrp) {
        GlAcc acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = gl_acc_zero();
        const u64* Mj = M + (size_t)j * 128 * 128 + k;
        const u64* sj = src + j * 128;
        for (int l = 0; l < 128; ++l) {
            const u64 m = Mj[l * 128];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
                gl_acc_madd(acc[r], sj[r * C + l], m);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
            dst[r * C + j * 128 + k] = gl_acc_reduce(acc[r]);
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

template <int ROWS>
__global__ void __launch_bounds__(1024)
fused_c_row_kernel(const u64* x, u64* out, const u64* u, int fwd, int op,
                   int inv, const u64* lane_f, const u64* lane_i,
                   const u64* Mf, const u64* Mi, int C, int ca) {
    extern __shared__ u64 row_smem[];
    u64* A = row_smem;
    u64* B = row_smem + ROWS * C;
    u64* D = row_smem + 2 * ROWS * C;
    const int tot = ROWS * C;
    const size_t base = (size_t)blockIdx.x * tot;
    for (int i = threadIdx.x; i < tot; i += blockDim.x) A[i] = x[base + i];
    if (fwd) {
        for (int i = threadIdx.x; i < ca * ca; i += blockDim.x)
            D[i] = lane_f[i];
        __syncthreads();
        row_lane_dft(A, B, D, ROWS, C, ca);
        __syncthreads();
        row_slot_mat<ROWS>(B, A, Mf, C, ca);
        __syncthreads();
    }
    // each thread touches the elements it loaded (or, after fwd, any:
    // the barrier above has passed)
    if (op != ROW_NONE)
        for (int i = threadIdx.x; i < tot; i += blockDim.x)
            A[i] = op == ROW_SQR ? gl_sqr(A[i]) : gl_mul(A[i], u[base + i]);
    if (inv) {
        for (int i = threadIdx.x; i < ca * ca; i += blockDim.x)
            D[i] = lane_i[i];
        __syncthreads();
        row_slot_mat<ROWS>(A, B, Mi, C, ca);
        __syncthreads();
        row_lane_dft(B, A, D, ROWS, C, ca);
        __syncthreads();
    }
    for (int i = threadIdx.x; i < tot; i += blockDim.x) out[base + i] = A[i];
}

template <int ROWS>
int row_launch(const u64* x, u64* out, const u64* u, int fwd, int op,
               int inv, const u64* lane_f, const u64* lane_i, const u64* Mf,
               const u64* Mi, int R, int C, int ca, cudaStream_t stream) {
    const size_t smem = (size_t)(2 * ROWS * C + ca * ca) * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(
        fused_c_row_kernel<ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = 128 * (ca < 8 ? ca : 8);
    fused_c_row_kernel<ROWS><<<R / ROWS, threads, smem, stream>>>(
        x, out, u, fwd, op, inv, lane_f, lane_i, Mf, Mi, C, ca);
    return (int)cudaGetLastError();
}

}  // namespace

// The row kernel over all R rows of a (R, C) register; may run in place
// (out == x: each block reads its rows before writing them). Rows per
// block: as many as two (rows x C) copies in 64 KiB when R fills the card
// (R >= 2048), up to 4; one otherwise, and always at C >= 8192.
static int fused_c_rows(const u64* x, u64* out, const u64* u, int fwd,
                        int op, int inv, const u64* lane_f,
                        const u64* lane_i, const u64* Mf, const u64* Mi,
                        int R, int C, cudaStream_t st) {
    const int ca = C / 128;
    if (C % 128 || ca < 2 || ca > 64) return -1;
    int rows = (R >= 2048) ? 4096 / C : 1;
    if (rows < 1) rows = 1;
    if (rows > 4) rows = 4;
    if (rows == 4)
        return row_launch<4>(x, out, u, fwd, op, inv, lane_f, lane_i, Mf, Mi,
                             R, C, ca, st);
    if (rows == 2)
        return row_launch<2>(x, out, u, fwd, op, inv, lane_f, lane_i, Mf, Mi,
                             R, C, ca, st);
    return row_launch<1>(x, out, u, fwd, op, inv, lane_f, lane_i, Mf, Mi, R,
                         C, ca, st);
}
