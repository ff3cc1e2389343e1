// K2: the fused C-transform of one step, with the r2 passes folded in.
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_fused_c_kernel in its r2fold
// form (:991, launched by fused_c_pass :1164), modes "sqr", "mul", "fwd".
// For each r1 the Pallas kernel holds all of (R2, C) in VMEM and runs
//   1. the r2 DFT with the generic L2 matrix, then x mf;
//   2. the lane-tile DFT over ca = c >> 7 (fourstep.dft_lanes :447);
//   3. per ca slot j one 128x128 right-side product with Mf[j]
//      (out[b, k] = sum_l x[b, l] * M[l, k]);
//   4. the square, or x u, or a stop for "fwd" (the stored multiplicand);
//   5. the mirror: Mi[j], the inverse lane DFT, x mi, the r2 inverse with
//      the r1's tr_inv matrix.
// One r1 slab at n = 2^23 is 64 x 2048 x 8 B = 1 MiB, more than a block's
// 227 KB of shared memory, so here the work is three launches, split at
// the r2 / C seams:
//   K2a  steps 1     axis kernel over r2 (axis_dft.cuh), x mf after;
//   K2b  steps 2-5a  one row per R2*r1 + r2: both buffers of a few rows
//                    in shared memory, lane DFT, slot products, the mode,
//                    the mirrored slot products and inverse lane DFT;
//   K2c  step 5b     x mi, then the axis kernel over r2 with tr_inv[r1].
// "fwd" stops after K2b's forward half, in the JAX spectral layout (same
// matrices, same DIF order), so a multiplicand agrees mod P with the JAX
// one and a checkpoint carries it across. All three run in place on out.
//
// What bounds it on the H100: 2*64 + 2*(ca + 128) + 3 mod-P products per
// digit (419 at ca = 16), so the integer pipe; the slot matrices (2 x 2 MB at
// ca = 16) stream from L2 once per block of rows. The design keeps each
// row's two working copies in shared memory, reuses every matrix word
// for all the block's rows, and reduces each dot product once (192-bit
// accumulator); the direct products are the simple form that a
// tensor-core or butterfly formulation would replace.

#include <cuda_runtime.h>

#include "axis_dft.cuh"

enum { K2_SQR = 0, K2_MUL = 1, K2_FWD = 2 };

// dst[r][q*128 + l] = sum_p D[q][p] * src[r][p*128 + l]
__device__ __forceinline__ void k2_lane_dft(const u64* src, u64* dst,
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
__device__ __forceinline__ void k2_slot_mat(const u64* src, u64* dst,
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

template <int ROWS>
__global__ void __launch_bounds__(1024)
k2b_kernel(u64* x, const u64* u, int mode, const u64* lane_f,
           const u64* lane_i, const u64* Mf, const u64* Mi, int C, int ca) {
    extern __shared__ u64 k2_smem[];
    u64* A = k2_smem;
    u64* B = k2_smem + ROWS * C;
    u64* D = k2_smem + 2 * ROWS * C;
    const int tot = ROWS * C;
    const size_t base = (size_t)blockIdx.x * tot;
    for (int i = threadIdx.x; i < tot; i += blockDim.x) A[i] = x[base + i];
    for (int i = threadIdx.x; i < ca * ca; i += blockDim.x) D[i] = lane_f[i];
    __syncthreads();
    k2_lane_dft(A, B, D, ROWS, C, ca);
    __syncthreads();
    k2_slot_mat<ROWS>(B, A, Mf, C, ca);
    __syncthreads();
    if (mode == K2_FWD) {
        for (int i = threadIdx.x; i < tot; i += blockDim.x) x[base + i] = A[i];
        return;
    }
    for (int i = threadIdx.x; i < tot; i += blockDim.x)
        A[i] = mode == K2_SQR ? gl_sqr(A[i]) : gl_mul(A[i], u[base + i]);
    for (int i = threadIdx.x; i < ca * ca; i += blockDim.x) D[i] = lane_i[i];
    __syncthreads();
    k2_slot_mat<ROWS>(A, B, Mi, C, ca);
    __syncthreads();
    k2_lane_dft(B, A, D, ROWS, C, ca);
    __syncthreads();
    for (int i = threadIdx.x; i < tot; i += blockDim.x) x[base + i] = A[i];
}

template <int ROWS>
static int k2b_launch(u64* x, const u64* u, int mode, const u64* lane_f,
                      const u64* lane_i, const u64* Mf, const u64* Mi,
                      int R, int C, int ca, cudaStream_t stream) {
    const size_t smem = (size_t)(2 * ROWS * C + ca * ca) * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(
        k2b_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = 128 * (ca < 8 ? ca : 8);
    k2b_kernel<ROWS><<<R / ROWS, threads, smem, stream>>>(
        x, u, mode, lane_f, lane_i, Mf, Mi, C, ca);
    return (int)cudaGetLastError();
}

extern "C" int prmers_k2_fused_c(const u64* x, u64* out, const u64* u,
                                 int mode, const u64* g2, const u64* mf,
                                 const u64* lane_f, const u64* lane_i,
                                 const u64* Mf, const u64* Mi,
                                 const u64* mi, const u64* tri,
                                 int R1, int L2, int C, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.mats = g2;
    g.tab = mf;
    g.O = R1;
    g.L = L2;
    g.S = 1;
    g.C = C;
    int err = axis_dft_launch<AX_K2A>(g, st);
    if (err) return err;

    const int R = R1 * L2;
    const int ca = C / 128;
    // rows per block: two (rows x C) u64 buffers in 64 KB of shared
    // memory when there are rows enough to fill the card, else one
    int rows = (R >= 2048) ? 4096 / C : 1;
    if (rows < 1) rows = 1;
    if (rows > 4) rows = 4;
    if (rows == 4)
        err = k2b_launch<4>(out, u, mode, lane_f, lane_i, Mf, Mi, R, C, ca, st);
    else if (rows == 2)
        err = k2b_launch<2>(out, u, mode, lane_f, lane_i, Mf, Mi, R, C, ca, st);
    else
        err = k2b_launch<1>(out, u, mode, lane_f, lane_i, Mf, Mi, R, C, ca, st);
    if (err || mode == K2_FWD) return err;

    g.x = out;
    g.mats = tri;
    g.tab = mi;
    return axis_dft_launch<AX_K2C>(g, st);
}
