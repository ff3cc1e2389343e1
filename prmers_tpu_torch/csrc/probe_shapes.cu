// The shape probes: each case of the TPU's reshape/concat/slice/int8-dot
// experiments computed by a kernel written here.
//
// Replaces prmers_tpu/tools/exp_mosaic_shapes.py:15 (cases a-f) and
// exp_mosaic_shapes2.py:15 (cases g-n), one pallas_call per case, which
// asked which in-kernel shapes Mosaic could lower for the MXU DFT design.
// A reshape has no legality question on Hopper, so each twin computes the
// case's result, and the caller holds it against the plain torch version:
//   a (64,8,8,128) -> (64,64,128) int32        merge of the middle dims
//   b (576,512) @ (512,64,128) int8 -> int32   3-D dot (contract dim 0)
//   c 8 x (64,64,128) int8 -> (512,64,128)     concat on axis 0
//   d (576,64,128) -> (9,64,64,128) int32      split of the leading dim
//   e (576,512) @ (512,1024) int8 -> int32     2-D dot
//   f (64,64,128) u32 -> u8 -> int8            truncate and reinterpret
//   g 8 x (512,128) int8 -> (512,1024)         concat on the lanes
//   h (576,1024)[64:128] int32                 row slice
//   i (576,1024)[:, 128:256] int32             lane slice
//   j sum_j<8 x[:, j, :] of (64,64,128) u32    scalar middle index
//   k o[:, j, :] = x[:, j, :] + 1, (64,8,128)  per-slice store
//   l x[:, 0, :] -> (64,1,128) u32             expand
//   m (64,8,128) int8 -> (64,1024) -> 8 x rows (512,1024)
//   n (576,512) @ (512,1024), then the sum of its nine 64-row slices
// The copy cases (a, c, d, f-m) are one instantiation each of copy_kernel
// on csrc/probe_copy.cuh's index maps: the case a template parameter, its
// dims compile-time constants, 32-bit index math (every case is below 2^21
// units), and each thread moves whole 16-byte units (W4: four words or 16
// bytes). f reads four units and writes one of 16 int8; k adds 1 to four
// words a unit; j sums eight units (rows j = 0..7) into one. The int8
// dots (b, e, n) are one launch of dot8_kernel on s8_mma.cuh's tile
// product (mma.sync m16n8k32 s8 on the tensor cores): 128 x 128 output
// tiles, A and B staged by cp.async into a three-stage ring, B turned
// K-major in shared memory; n sums its nine 64-row slices in the same
// launch (each warp row over its own slices, then one exchange through
// shared memory).
//
// What bounds it on the H100: the copies, their bytes (each input read
// once, each output written once: 0.000157 ms for k up to 0.011268 ms for
// d's 37.7 MB), so most sit at the launch floor of ~0.005 ms; only d is
// long enough to be bound by the HBM. Its grid is one wave (8 blocks of
// 256 threads an SM) that takes d in passes, each a contiguous 4.3 MB of
// the input, so the HBM serves one stream in order: with all its 18.9 MB
// of loads in flight at once (eight units a thread, one pass) it read
// slower from a cold L2 than this, though faster from a warm one. The
// dots, at 603 MFLOP (e) to 4.8 GFLOP (b) of int8 work, the bytes: b moves
// 23.4 MB (0.0070 ms at 3.35 TB/s) against 0.0024 ms of int8 operations,
// e 3.2 MB (0.00095 ms), near the launch floor.

#include <cuda_runtime.h>

#include "probe_copy.cuh"
#include "s8_mma.cuh"

namespace {

#define COPY_THREADS 256

// One case's copy: thread t of the grid builds output units t, t + the
// grid's threads, ... (one pass where the grid covers the case).
template <int CS>
__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(const W4* __restrict__ in, W4* __restrict__ out) {
    const int step = gridDim.x * COPY_THREADS;
    for (int q = blockIdx.x * COPY_THREADS + threadIdx.x; q < COPY_UNITS<CS>;
         q += step)
        out[q] = copy_unit<CS>(in, q);
}

// a block a COPY_THREADS units, at most the blocks the SMs hold at once
// (2048 threads each): one pass below that, else passes over one wave
template <int CS>
int copy_launch(const void* in, void* out, cudaStream_t st) {
    static int sms = 0;
    if (!sms) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 132;
    }
    const int need = (COPY_UNITS<CS> + COPY_THREADS - 1) / COPY_THREADS;
    const int cap = sms * (2048 / COPY_THREADS);
    copy_kernel<CS><<<need < cap ? need : cap, COPY_THREADS, 0, st>>>(
        (const W4*)in, (W4*)out);
    return (int)cudaGetLastError();
}

#define D8_THREADS 256
#define D8_TM 128        // rows of a block tile (two warp rows of 64)
#define D8_TN 128        // columns of a block tile (four warps of 32)
#define D8_KC 128        // contraction bytes of a ring stage
#define D8_STAGES 3
#define D8_STAGE (D8_TM * D8_KC + D8_KC * D8_TN)
#define D8_SMEM (D8_STAGES * D8_STAGE + D8_TN * D8_KC)

// unit u of row k of the staged (K-rows, N-bytes) B chunk: rows 4 q + i of
// one transpose load read units (u ^ 2 (q & 3)), 8 distinct for a warp's
// 8 column-groups x 4 q
__device__ __forceinline__ int d8_raw(int k, int u) {
    return k * D8_TN + 16 * (u ^ (((k >> 2) & 3) << 1));
}

// C (M, N) int32 = A (M, K) int8 @ B (K, N) int8 (row-major, N
// contiguous), or with fold (= 64, M % 64 == 0) C (64, N) = the sum of
// the product's 64-row slices. The block takes a 128 x 128 tile (fold:
// all of M, a 128-row step at a time, each warp row summing its own
// slices); each ring stage holds 128 contraction bytes of A's 128 rows
// (S8SwzA) and of B's 128 columns as they lie, N-major; after its wait the
// block turns the stage's B into bt (column-major, S8SwzB), one 4 x
// 4-byte block a lane at a time, and the warps run s8_warp_k32 on it.
// Past M, N and K the stages are zero-filled, so any M, and N, K
// multiples of 16, work.
__global__ void __launch_bounds__(D8_THREADS, 2)
dot8_kernel(const signed char* A, const signed char* B, int* Cm, int M,
            int N, int K, int fold) {
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* bt = smem + D8_STAGES * D8_STAGE;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3;
    const int n0 = blockIdx.x * D8_TN;
    const int m0 = fold ? 0 : blockIdx.y * D8_TM;
    const int steps = fold ? (M + D8_TM - 1) / D8_TM : 1;
    const int nk = (K + D8_KC - 1) / D8_KC;
    const int total = steps * nk;

    auto issue = [&](int q) {
        if (q < total) {
            unsigned char* a = smem + (q % D8_STAGES) * D8_STAGE;
            unsigned char* b = a + D8_TM * D8_KC;
            const int r0 = m0 + (q / nk) * D8_TM, k0 = (q % nk) * D8_KC;
            for (int t = tid; t < D8_TM * D8_KC / 16; t += D8_THREADS) {
                const int r = t >> 3, u = t & 7;
                const int kb = K - (k0 + 16 * u);
                const int nb = r0 + r < M ? (kb < 0 ? 0 : kb < 16 ? kb : 16)
                                          : 0;
                s8_cp_async16(a + S8SwzA()(r, u),
                              nb ? A + (size_t)(r0 + r) * K + k0 + 16 * u
                                 : A,
                              nb);
            }
            for (int t = tid; t < D8_KC * D8_TN / 16; t += D8_THREADS) {
                const int k = t >> 3, u = t & 7;
                const bool in = k0 + k < K && n0 + 16 * u < N;
                s8_cp_async16(b + d8_raw(k, u),
                              in ? B + (size_t)(k0 + k) * N + n0 + 16 * u
                                 : B,
                              in ? 16 : 0);
            }
        }
        s8_cp_commit();
    };
#pragma unroll
    for (int q = 0; q < D8_STAGES - 1; ++q) issue(q);

    int acc[4][4][4];
    s8_zero<4>(acc);
    for (int q = 0; q < total; ++q) {
        s8_cp_wait<D8_STAGES - 2>();
        __syncthreads();
        issue(q + D8_STAGES - 1);
        const unsigned char* a = smem + (q % D8_STAGES) * D8_STAGE;
        const unsigned char* b = a + D8_TM * D8_KC;
        // the transpose: 32 x 32 blocks of 4 x 4 bytes in 32 groups of 8
        // column-groups x 4 contraction-groups, four groups a warp
#pragma unroll
        for (int grp = warp; grp < 32; grp += D8_THREADS / 32) {
            const int nq = (grp & 3) * 8 + (lane & 7);
            const int kq = (grp >> 2) * 4 + (lane >> 3);
            u32 rw[4], cw[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                rw[i] = *(const u32*)(b + d8_raw(4 * kq + i, nq >> 2) +
                                      4 * (nq & 3));
            s8_transpose4x4(rw, cw);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                *(u32*)(bt + S8SwzB()(4 * nq + i, kq >> 2) + 4 * (kq & 3)) =
                    cw[i];
        }
        __syncthreads();
        const int r0 = m0 + (q / nk) * D8_TM + 64 * wm;
        if (r0 < M) {
            const unsigned char* aw = a + 64 * wm * D8_KC;
            const unsigned char* bw = bt + 32 * wn * D8_KC;
#pragma unroll
            for (int ks = 0; ks < D8_KC / 32; ++ks)
                s8_warp_k32<4>(acc, aw, S8SwzA(), 2 * ks, bw, S8SwzB(),
                               2 * ks, lane);
        }
        if (!fold && q == total - 1 && r0 < M) {
            const int g = lane >> 2, t = lane & 3;
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = r0 + 16 * mt + g + 8 * h;
                    if (r >= M) continue;
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) {
                        const int c = n0 + 32 * wn + 8 * nt + 2 * t;
                        if (c < N)
                            *(int2*)(Cm + (size_t)r * N + c) = make_int2(
                                acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
                    }
                }
        }
    }
    s8_cp_wait<0>();
    if (fold) {
        // warp row 1's sums through shared memory into row 0's
        int* red = (int*)smem;
        __syncthreads();
        if (wm == 1)
#pragma unroll
            for (int j = 0; j < 64; ++j)
                red[j * 128 + tid - 128] = acc[j >> 4][(j >> 2) & 3][j & 3];
        __syncthreads();
        if (wm == 0) {
#pragma unroll
            for (int j = 0; j < 64; ++j)
                acc[j >> 4][(j >> 2) & 3][j & 3] += red[j * 128 + tid];
            const int g = lane >> 2, t = lane & 3;
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    const int c = n0 + 32 * wn + 8 * nt + 2 * t;
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        if (c < N)
                            *(int2*)(Cm + (size_t)(16 * mt + g + 8 * h) * N +
                                     c) = make_int2(acc[mt][nt][2 * h],
                                                    acc[mt][nt][2 * h + 1]);
                }
        }
    }
}

}  // namespace

// One copy case (its own instantiation; the case's shapes are fixed);
// returns cudaGetLastError(), or -1 for an unknown case.
extern "C" int prmers_probe_copy(int cs, const void* in, void* out,
                                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (cs) {
        case 'a': return copy_launch<'a'>(in, out, st);
        case 'c': return copy_launch<'c'>(in, out, st);
        case 'd': return copy_launch<'d'>(in, out, st);
        case 'f': return copy_launch<'f'>(in, out, st);
        case 'g': return copy_launch<'g'>(in, out, st);
        case 'h': return copy_launch<'h'>(in, out, st);
        case 'i': return copy_launch<'i'>(in, out, st);
        case 'j': return copy_launch<'j'>(in, out, st);
        case 'k': return copy_launch<'k'>(in, out, st);
        case 'l': return copy_launch<'l'>(in, out, st);
        case 'm': return copy_launch<'m'>(in, out, st);
    }
    return -1;
}

// C = A @ B (int8 in, int32 out), or with fold = 64 the (64, N) sum of
// the product's 64-row slices, in one launch. Returns cudaGetLastError(),
// or -1 for a shape the kernel does not take (N or K not a multiple of 16,
// a fold other than 0 or 64, or M not a multiple of it).
extern "C" int prmers_probe_dot8(const signed char* A, const signed char* B,
                                 int* Cm, int M, int N, int K, int fold,
                                 void* stream) {
    if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 16) return -1;
    if (fold != 0 && (fold != 64 || M % 64)) return -1;
    cudaError_t err = cudaFuncSetAttribute(
        dot8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D8_SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + D8_TN - 1) / D8_TN, fold ? 1 : (M + D8_TM - 1) / D8_TM);
    dot8_kernel<<<grid, D8_THREADS, D8_SMEM, (cudaStream_t)stream>>>(
        A, B, Cm, M, N, K, fold);
    return (int)cudaGetLastError();
}
