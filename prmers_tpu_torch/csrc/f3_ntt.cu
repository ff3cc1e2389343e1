// K10-K12: the second arithmetic's transform (fft3161) on the H100, one
// launch per stage over both planes.
//
// The JAX package's fft3161 path (prmers_tpu/ops/ntt2.py,
// engine/engine3161.py) is XLA code with no Pallas kernel, so these
// replace no pallas_call: they stand for ntt2.plane_fwd's DIF stage
// (:264-289) with forward_3161's weights (:320-332) in the first (K10),
// plane_inv's DIT stage (:291-317) with inverse_3161's unweights, real
// part and CRT (:334-356) in the last (K11), and Fq2Ops.sqr/mul on the
// spectrum (K12). Ported op for op into torch, a radix-4 stage is ~300
// launches per plane and direction; here it is one.
//
// What bounds them: bytes. A stage reads and writes both planes once
// (12 bytes per (re, im) word pair of M31 and M61 together: 4 + 8, twice)
// plus the stage's twiddles, against a few canonical products per word
// (~3 per twiddle, ~12 in the radix-3 butterfly). The design is the
// simple one: one thread per (block, column), the r values of each plane
// in registers, in place; the bodies are csrc/f3_ntt.cuh's.

#include <cuda_runtime.h>

#include "f3_ntt.cuh"

#define F3_THREADS 256

template <int R>
__global__ void __launch_bounds__(F3_THREADS) f3_fwd_kernel(StageArgs s) {
    const long t = (long)blockIdx.x * F3_THREADS + threadIdx.x;
    if (t < (long)s.B * s.m) f3_fwd_item<R>(s, t);
}

template <int R>
__global__ void __launch_bounds__(F3_THREADS) f3_inv_kernel(StageArgs s) {
    const long t = (long)blockIdx.x * F3_THREADS + threadIdx.x;
    if (t < (long)s.B * s.m) f3_inv_item<R>(s, t);
}

__global__ void __launch_bounds__(F3_THREADS)
f3_pointwise_kernel(u32* x31, u64* x61, const u32* m31, const u64* m61,
                    int n) {
    const long i = (long)blockIdx.x * F3_THREADS + threadIdx.x;
    if (i < n) f3_pointwise_item(x31, x61, m31, m61, n, i);
}

static int f3_launch(bool inverse, const StageArgs& s, cudaStream_t st) {
    const long items = (long)s.B * s.m;
    if (items <= 0 || items * s.r != s.n) return -1;
    const unsigned grid = (unsigned)((items + F3_THREADS - 1) / F3_THREADS);
    switch (s.r) {
    case 2:
        if (inverse) f3_inv_kernel<2><<<grid, F3_THREADS, 0, st>>>(s);
        else f3_fwd_kernel<2><<<grid, F3_THREADS, 0, st>>>(s);
        break;
    case 3:
        if (inverse) f3_inv_kernel<3><<<grid, F3_THREADS, 0, st>>>(s);
        else f3_fwd_kernel<3><<<grid, F3_THREADS, 0, st>>>(s);
        break;
    case 4:
        if (inverse) f3_inv_kernel<4><<<grid, F3_THREADS, 0, st>>>(s);
        else f3_fwd_kernel<4><<<grid, F3_THREADS, 0, st>>>(s);
        break;
    default:
        return -1;
    }
    return (int)cudaGetLastError();
}

// K10: forward stage (r, m, B) in place on x31 (2, n) u32 and x61 (2, n)
// u64; d non-null (the first stage) reads the digits and the weights w31,
// w61 instead of x
extern "C" int prmers_f3_fwd_stage(u32* x31, u64* x61, const u32* tw31,
                                   const u64* tw61, const u32* w31,
                                   const u64* w61, int r, int m, int B,
                                   int n, const u64* d, u32 w3r31,
                                   u32 w3i31, u64 w3r61, u64 w3i61,
                                   int neg4_31, int neg4_61, void* stream) {
    if (d && (!w31 || !w61)) return -1;
    const StageArgs s = f3_stage_args(
        x31, x61, tw31, tw61, w31, w61, r, m, B, n, d, nullptr, nullptr, 0,
        w3r31, w3i31, w3r61, w3i61, neg4_31, neg4_61);
    return f3_launch(false, s, (cudaStream_t)stream);
}

// K11: inverse stage in place; lo, hi non-null (the last stage) fold the
// unweights uw31, uw61 and write the CRT's (lo, hi) (n,) u64 instead
extern "C" int prmers_f3_inv_stage(u32* x31, u64* x61, const u32* twi31,
                                   const u64* twi61, const u32* uw31,
                                   const u64* uw61, int r, int m, int B,
                                   int n, u64* lo, u64* hi, u64 crt,
                                   u32 w3r31, u32 w3i31, u64 w3r61,
                                   u64 w3i61, int neg4_31, int neg4_61,
                                   void* stream) {
    if ((lo != nullptr) != (hi != nullptr) || (lo && (!uw31 || !uw61)))
        return -1;
    const StageArgs s = f3_stage_args(
        x31, x61, twi31, twi61, uw31, uw61, r, m, B, n, nullptr, lo, hi,
        crt, w3r31, w3i31, w3r61, w3i61, neg4_31, neg4_61);
    return f3_launch(true, s, (cudaStream_t)stream);
}

// K12: x = x^2 (m31, m61 null) or x * m, in place, both planes
extern "C" int prmers_f3_pointwise(u32* x31, u64* x61, const u32* m31,
                                   const u64* m61, int n, void* stream) {
    if (n <= 0 || (m31 == nullptr) != (m61 == nullptr)) return -1;
    const unsigned grid = (unsigned)((n + F3_THREADS - 1) / F3_THREADS);
    f3_pointwise_kernel<<<grid, F3_THREADS, 0, (cudaStream_t)stream>>>(
        x31, x61, m31, m61, n);
    return (int)cudaGetLastError();
}
