// The rep-loop microbenchmark kernels: one operation applied `reps` times
// to every element, each rep depending on the last, so the loop cannot be
// dropped or hoisted.
//
// Replaces the TPU probes
//   prmers_tpu/tools/microbench3.py:77  (vpu_kernel: y = y * x + 1, int32,
//       256 reps on (512, 1024));
//   prmers_tpu/tools/microbench3.py:152 (mulmod_kernel: x = x * b mod P on
//       u32 pairs from 16-bit pieces, 256 reps on (512, 1024));
//   prmers_tpu/tools/microbench_fields.py:71 (bench_kernel's rep loop of
//       gl64 mul/sqr, GF(M31^2) mul/sqr, GF(M61^2) mul/sqr, 64 reps on
//       (256, 1024)).
// The data are planes of u32 words, as the TPU's arrays: `in` holds the
// operation's n_in planes of N words (x; or a, b as (lo, hi) pairs; or the
// complex components, an M61 one as a (lo, hi) pair), `out` the first n_out
// planes of the state after the loop (the b operands pass through). The
// TPU's 16-bit decomposition of a 64-bit product is the TPU's own way to
// compute it; here a gl64 or M61 product is the native 64 x 64 -> 128
// (__umul64hi), and each result equals the original's mod P (mod M31,
// M61): csrc/gl64.cuh, csrc/mers.cuh.
//
// What bounds it on the H100: the integer pipe, by design (a probe of its
// rate). Each thread keeps its element in registers for the whole loop;
// device traffic is n_in + n_out words per element, once.

#include <cuda_runtime.h>

#include "mers.cuh"

enum RepOp {
    REP_VPU = 0,      // y = y * x + 1 (u32, wraps as int32 does)
    REP_GL_MUL = 1,   // a = a * b mod P       (a, b: (lo, hi) planes)
    REP_GL_SQR = 2,   // a = a^2 mod P
    REP_M31_MUL = 3,  // (ar, ai) = (ar, ai) * (br, bi) in GF(M31^2)
    REP_M31_SQR = 4,
    REP_M61_MUL = 5,  // (ar, ai) * (br, bi) in GF(M61^2), pairs
    REP_M61_SQR = 6
};

namespace {

__device__ __forceinline__ u64 pair_at(const u32* in, int plane, size_t N,
                                       size_t i) {
    return (u64)in[plane * N + i] | ((u64)in[(plane + 1) * N + i] << 32);
}

template <int OP>
__global__ void __launch_bounds__(256)
rep_kernel(const u32* in, u32* out, int n_out, int reps, size_t N) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    u32 w[8];
    int nw = 0;
    if (OP == REP_VPU) {
        const u32 x = in[i];
        u32 y = x;
        for (int r = 0; r < reps; ++r) y = y * x + 1u;
        w[nw++] = y;
    } else if (OP == REP_GL_MUL || OP == REP_GL_SQR) {
        u64 a = pair_at(in, 0, N, i);
        if (OP == REP_GL_MUL) {
            const u64 b = pair_at(in, 2, N, i);
            for (int r = 0; r < reps; ++r) a = gl_mul(a, b);
        } else {
            for (int r = 0; r < reps; ++r) a = gl_sqr(a);
        }
        w[nw++] = (u32)a;
        w[nw++] = (u32)(a >> 32);
        if (OP == REP_GL_MUL) {
            w[nw++] = in[2 * N + i];
            w[nw++] = in[3 * N + i];
        }
    } else if (OP == REP_M31_MUL || OP == REP_M31_SQR) {
        u32 ar = in[i], ai = in[N + i];
        if (OP == REP_M31_MUL) {
            const u32 br = in[2 * N + i], bi = in[3 * N + i];
            for (int r = 0; r < reps; ++r) m31c_mul(ar, ai, br, bi, ar, ai);
        } else {
            for (int r = 0; r < reps; ++r) m31c_sqr(ar, ai, ar, ai);
        }
        w[nw++] = ar;
        w[nw++] = ai;
        if (OP == REP_M31_MUL) {
            w[nw++] = in[2 * N + i];
            w[nw++] = in[3 * N + i];
        }
    } else {
        u64 ar = pair_at(in, 0, N, i), ai = pair_at(in, 2, N, i);
        if (OP == REP_M61_MUL) {
            const u64 br = pair_at(in, 4, N, i), bi = pair_at(in, 6, N, i);
            for (int r = 0; r < reps; ++r) m61c_mul(ar, ai, br, bi, ar, ai);
        } else {
            for (int r = 0; r < reps; ++r) m61c_sqr(ar, ai, ar, ai);
        }
        w[nw++] = (u32)ar;
        w[nw++] = (u32)(ar >> 32);
        w[nw++] = (u32)ai;
        w[nw++] = (u32)(ai >> 32);
        if (OP == REP_M61_MUL)
            for (int p = 4; p < 8; ++p) w[nw++] = in[p * N + i];
    }
    for (int p = 0; p < n_out && p < nw; ++p) out[p * N + i] = w[p];
}

template <int OP>
int rep_launch(const u32* in, u32* out, int n_out, int reps, size_t N,
               cudaStream_t st) {
    const unsigned blocks = (unsigned)((N + 255) / 256);
    rep_kernel<OP><<<blocks, 256, 0, st>>>(in, out, n_out, reps, N);
    return (int)cudaGetLastError();
}

}  // namespace

// returns cudaGetLastError(), or -1 for an unknown op
extern "C" int prmers_probe_reps(int op, const u32* in, u32* out, int n_out,
                                 int reps, long long N, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (N <= 0 || reps < 0 || n_out < 1 || n_out > 8) return -1;
    switch (op) {
        case REP_VPU: return rep_launch<REP_VPU>(in, out, n_out, reps, N, st);
        case REP_GL_MUL:
            return rep_launch<REP_GL_MUL>(in, out, n_out, reps, N, st);
        case REP_GL_SQR:
            return rep_launch<REP_GL_SQR>(in, out, n_out, reps, N, st);
        case REP_M31_MUL:
            return rep_launch<REP_M31_MUL>(in, out, n_out, reps, N, st);
        case REP_M31_SQR:
            return rep_launch<REP_M31_SQR>(in, out, n_out, reps, N, st);
        case REP_M61_MUL:
            return rep_launch<REP_M61_MUL>(in, out, n_out, reps, N, st);
        case REP_M61_SQR:
            return rep_launch<REP_M61_SQR>(in, out, n_out, reps, N, st);
    }
    return -1;
}
