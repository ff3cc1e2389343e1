// K7: the carry of the block-carry pipeline, over each r1 block.
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_k4_kernel (:1315, launched by
// k4 :1407, pallas_call :1431). An r1 block is R2 * C digits in flat order
// (B = 131072 at n = 2^23, up to 1048576 at 2^26). For each block:
//   1. optionally canon(y * a) (with_a; with a = 1 the multiply is skipped,
//      which is bit-identical because K4 inverse's output is canonical);
//   2. the digit/carry split by width;
//   3. `rounds` shift-by-one rounds (the block's first digit takes 0, what
//      leaves its last digit adds into the 64-bit block carry), then a
//      last shift whose residual is added unsplit;
//   4. the digits, and the block carry, left for the next step's K4.
// The same body with K8's round rule (sharded_pallas.py:_k4_local, a
// larger `rounds`) is K8's per-shard kernel; `rounds` is a run-time
// argument for that reason.
//
// What bounds it on the H100: memory. Per digit it reads 8 B of y and 4 B
// of width and writes 8 B, about 20 B against a few integer operations
// per round. An r1 block is far larger than a CUDA block's shared memory
// (K3b holds a whole unit of at most 4096 digits), and a grid of one CUDA
// block per r1 block would be 64 blocks for 132 SMs. After rounds + 1
// shifts a digit depends only on itself and the rounds + 1 digits before
// it, so each CUDA block takes a slab of K7_OWN digits of one r1 block and
// loads K7_HALO digits before it as well (zeros before the block's start),
// recomputes their rounds, and writes only its slab: 1 + K7_HALO / K7_OWN
// of the data is read, and the grid is (slabs, R1). The slab that holds
// the block's last digit writes the block carry. Each round keeps the
// carries in shared memory, one __syncthreads per round, as K3b does.
// A block reads digits that the slab before it writes, so y and out must
// not overlap.

#include <cuda_runtime.h>

#include "gl64.cuh"

#define K7_THREADS 256
#define K7_PER 8
#define K7_WIN (K7_THREADS * K7_PER)   // digits loaded per CUDA block
#define K7_HALO 32                      // of them before the slab
#define K7_OWN (K7_WIN - K7_HALO)       // digits written per CUDA block

__global__ void __launch_bounds__(K7_THREADS)
k7_kernel(const u64* y, u64* out, u64* co, const u32* widths, u64 a,
          int with_a, int rounds, int B) {
    __shared__ u64 cs[K7_WIN];
    const int tid = threadIdx.x;
    const size_t base = (size_t)blockIdx.y * B;
    // window position l is digit start + l of the r1 block
    const long start = (long)blockIdx.x * K7_OWN - K7_HALO;
    u64 d[K7_PER], c[K7_PER];
    u32 w[K7_PER];
#pragma unroll
    for (int i = 0; i < K7_PER; ++i) {
        const long pos = start + tid + i * K7_THREADS;
        if (pos < 0 || pos >= B) {
            // no digit: it holds nothing and passes nothing on
            d[i] = 0;
            c[i] = 0;
            w[i] = 1;
            continue;
        }
        u64 v = y[base + pos];
        w[i] = widths[base + pos];
        if (with_a) v = gl_canon(gl_mul(v, a));
        d[i] = v & ((1ULL << w[i]) - 1ULL);
        c[i] = v >> w[i];
    }
    u64 acc = 0;
    for (int r = 0; r <= rounds; ++r) {
#pragma unroll
        for (int i = 0; i < K7_PER; ++i) {
            cs[tid + i * K7_THREADS] = c[i];
            if (start + tid + i * K7_THREADS == B - 1) acc += c[i];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < K7_PER; ++i) {
            const int l = tid + i * K7_THREADS;
            const u64 sh = l > 0 ? cs[l - 1] : 0ULL;
            if (r < rounds) {
                const u64 v = d[i] + sh;
                d[i] = v & ((1ULL << w[i]) - 1ULL);
                c[i] = v >> w[i];
            } else {
                // the residual (< 2^(wmin-1)) goes in unsplit
                d[i] = (u64)(u32)(d[i] + (u32)sh);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < K7_PER; ++i) {
        const int l = tid + i * K7_THREADS;
        const long pos = start + l;
        if (l < K7_HALO || pos >= B) continue;
        out[base + pos] = d[i];
        if (pos == B - 1) co[blockIdx.y] = acc;
    }
}

extern "C" int prmers_k7_block_carry(const u64* y, u64* out, u64* co,
                                     const u32* widths, u64 a, int with_a,
                                     int rounds, int R1, int B,
                                     void* stream) {
    // the halo must cover the rounds + 1 digits a digit depends on
    if (rounds < 1 || rounds + 1 > K7_HALO || B <= 0 || R1 <= 0) return -1;
    dim3 grid((B + K7_OWN - 1) / K7_OWN, R1);
    k7_kernel<<<grid, K7_THREADS, 0, (cudaStream_t)stream>>>(
        y, out, co, widths, a, with_a, rounds, B);
    return (int)cudaGetLastError();
}
