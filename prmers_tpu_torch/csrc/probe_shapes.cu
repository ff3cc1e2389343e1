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
// The copy cases are index kernels, one thread per output element (the
// case's source index computed from the input's dims d0..d2). The int8
// dots (b, e, n) are one hand-written product: a 64 x 64 output tile per
// block of 256 threads, 4 x 4 outputs per thread, K in steps of 32 with
// A's rows and B's columns packed four int8 per int32 in shared memory and
// summed with __dp4a (four signed byte products and an add per
// instruction); n adds its nine row slices in a second launch.
//
// What bounds it on the H100: the copies, their bytes; the dots, at 603
// MFLOP (e) to 4.8 GFLOP (b) of int8 work, the int8 rate, which __dp4a on
// the integer pipe reaches only a fraction of (no tensor cores here: a
// later change would take mma.sync or wgmma).

#include <cuda_runtime.h>

namespace {

template <typename Ti, typename To>
__global__ void copy_kernel(char cs, const Ti* in, To* out, long long total,
                            int d0, int d1, int d2) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    long long src = i;
    switch (cs) {
        case 'c':
            src = i % ((long long)d0 * d1 * d2);
            break;
        case 'g': {
            const long long w = 8LL * d1;
            src = (i / w) * d1 + (i % w) % d1;
            break;
        }
        case 'h':
            src = i + 64LL * d1;
            break;
        case 'i':
            src = (i / 128) * d1 + 128 + i % 128;
            break;
        case 'j': {
            const long long r = i / d2, c = i % d2;
            unsigned int s = 0;
            for (int j = 0; j < 8; ++j)
                s += (unsigned int)in[(r * d1 + j) * d2 + c];
            out[i] = (To)s;
            return;
        }
        case 'l':
            src = (i / d2) * d1 * d2 + i % d2;
            break;
        case 'm': {
            const long long w = (long long)d1 * d2;
            const long long R = i / w, q = i % w;
            src = ((R % d0) * d1 + q / d2) * d2 + q % d2;
            break;
        }
    }
    if (cs == 'f')
        out[i] = (To)(signed char)(unsigned char)(in[src] & 0xFF);
    else if (cs == 'k')
        out[i] = (To)(in[src] + 1u);
    else
        out[i] = (To)in[src];
}

template <typename Ti, typename To>
int copy_launch(char cs, const void* in, void* out, long long total, int d0,
                int d1, int d2, cudaStream_t st) {
    const unsigned blocks = (unsigned)((total + 255) / 256);
    copy_kernel<Ti, To><<<blocks, 256, 0, st>>>(
        cs, (const Ti*)in, (To*)out, total, d0, d1, d2);
    return (int)cudaGetLastError();
}

// C (M, N) int32 = A (M, K) int8 @ B (K, N) int8, M and N multiples of 64,
// K of 32
__global__ void __launch_bounds__(256)
dot8_kernel(const signed char* A, const signed char* B, int* Cm, int M,
            int N, int K) {
    __shared__ int As[64][9];      // 64 rows x 32 k, four k per int
    __shared__ int Bs[8][65];      // 32 k packed by four x 64 columns
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int row0 = blockIdx.y * 64, col0 = blockIdx.x * 64;
    int acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += 32) {
        for (int t = tid; t < 512; t += 256) {
            const int r = t / 8, kq = t % 8;
            As[r][kq] = *(const int*)(A + (size_t)(row0 + r) * K + k0 +
                                      4 * kq);
        }
        for (int t = tid; t < 512; t += 256) {
            const int kq = t / 64, c = t % 64;
            const signed char* b = B + (size_t)(k0 + 4 * kq) * N + col0 + c;
            Bs[kq][c] = (int)((unsigned)(unsigned char)b[0] |
                              ((unsigned)(unsigned char)b[N] << 8) |
                              ((unsigned)(unsigned char)b[2 * N] << 16) |
                              ((unsigned)(unsigned char)b[3 * N] << 24));
        }
        __syncthreads();
        for (int kq = 0; kq < 8; ++kq) {
            int a[4], bb[4];
            for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kq];
            for (int j = 0; j < 4; ++j) bb[j] = Bs[kq][tx + 16 * j];
            for (int i = 0; i < 4; ++i)
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = __dp4a(a[i], bb[j], acc[i][j]);
        }
        __syncthreads();
    }
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j)
            Cm[(size_t)(row0 + ty + 16 * i) * N + col0 + tx + 16 * j] =
                acc[i][j];
}

// out (fold, N) = sum over the M / fold row slices of D (M, N)
__global__ void fold_rows_kernel(const int* D, int* out, int M, int N,
                                 int fold) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)fold * N) return;
    int s = 0;
    for (int m = 0; m < M / fold; ++m) s += D[(size_t)m * fold * N + i];
    out[i] = s;
}

}  // namespace

// One copy case; returns cudaGetLastError(), or -1 for an unknown case.
extern "C" int prmers_probe_copy(int cs, const void* in, void* out,
                                 long long total, int d0, int d1, int d2,
                                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (total <= 0) return -1;
    switch (cs) {
        case 'a': case 'd': case 'h': case 'i':
            return copy_launch<int, int>(cs, in, out, total, d0, d1, d2, st);
        case 'c': case 'g': case 'm':
            return copy_launch<signed char, signed char>(cs, in, out, total,
                                                         d0, d1, d2, st);
        case 'f':
            return copy_launch<unsigned int, signed char>(cs, in, out, total,
                                                          d0, d1, d2, st);
        case 'j': case 'k': case 'l':
            return copy_launch<unsigned int, unsigned int>(cs, in, out,
                                                           total, d0, d1, d2,
                                                           st);
    }
    return -1;
}

// C = A @ B (int8 in, int32 out); with fold > 0, C (fold, N) is the sum of
// the product's M / fold row slices, formed in scratch (M, N) first.
extern "C" int prmers_probe_dot8(const signed char* A, const signed char* B,
                                 int* Cm, int M, int N, int K, int fold,
                                 int* scratch, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M % 64 || N % 64 || K % 32 || M <= 0 || N <= 0 || K <= 0) return -1;
    if (fold < 0 || (fold > 0 && (M % fold || scratch == nullptr))) return -1;
    dim3 grid(N / 64, M / 64);
    dot8_kernel<<<grid, 256, 0, st>>>(A, B, fold ? scratch : Cm, M, N, K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !fold) return (int)err;
    const long long total = (long long)fold * N;
    fold_rows_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        scratch, Cm, M, N, fold);
    return (int)cudaGetLastError();
}
