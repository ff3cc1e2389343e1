// K3b's body: the carry of one carry unit (steps 4-6 of K3, k3_p7c.cu),
// shared by K3 and the persistent K9 kernel (k9_chain.cu).
#pragma once

#include "gl64.cuh"

#define K3B_THREADS 256

// Unit f of ct = PER * 256 digits on K3B_THREADS threads and
// PER * K3B_THREADS u64 of shared memory at cs; thread tid owns digits
// tid, tid + 256, ... (PER of them, in registers), so loads and stores are
// coalesced and each round's shifted carry comes from shared memory. It
// opens with a barrier, so a block may run one unit after another on the
// same buffer.
template <int PER>
__device__ __forceinline__ void k3b_unit(u64* x, u64* co, const u32* widths,
                                         int rounds, int sub2, u64 s2, int f,
                                         u64* cs, int tid) {
    const int ct = PER * K3B_THREADS;
    const size_t base = (size_t)f * ct;
    u64 d[PER], c[PER];
    u32 w[PER];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int l = tid + i * K3B_THREADS;
        u64 y = x[base + l];
        w[i] = widths[base + l];
        const u64 mk = (1ULL << w[i]) - 1ULL;
        if (sub2) y += (f == 0 && l == 0) ? mk - s2 : mk;
        d[i] = y & mk;
        c[i] = y >> w[i];
    }
    u64 acc = 0;
    for (int r = 0; r <= rounds; ++r) {
#pragma unroll
        for (int i = 0; i < PER; ++i) cs[tid + i * K3B_THREADS] = c[i];
        __syncthreads();
        if (tid == K3B_THREADS - 1) acc += c[PER - 1];   // leaves the unit
#pragma unroll
        for (int i = 0; i < PER; ++i) {
            const int l = tid + i * K3B_THREADS;
            const u64 sh = l > 0 ? cs[l - 1] : 0ULL;
            if (r < rounds) {
                const u64 y = d[i] + sh;
                d[i] = y & ((1ULL << w[i]) - 1ULL);
                c[i] = y >> w[i];
            } else {
                // the residual (< 2^(wmin-1)) goes in unsplit
                d[i] = (u64)(u32)(d[i] + (u32)sh);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) x[base + tid + i * K3B_THREADS] = d[i];
    if (tid == K3B_THREADS - 1) co[f] = acc;
}
