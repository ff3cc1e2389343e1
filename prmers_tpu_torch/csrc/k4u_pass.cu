// K4u and K5u: the unfolded r passes, down axis 0 (r1, K4u) or axis 1
// (r2, K5u) of the (R1, R2, C) register, in one body as the Pallas kernel
// has one.
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_pass_kernel (:130) in the
// forms that _forward_r and _inverse_r (:1530-1571) take, launched by
// _axis0_pass (pallas_call :365) and _axis1_pass (pallas_call :452). Per
// element, in the Pallas kernel's order:
//   1. with wrap residues (er, ec) and not canon: halve where er + ec >= n;
//   2. with a scalar carry cin: its parts, spread base-2^width over the
//      widths cin_widths, added to digits 0 ... kk-1 of the register (r1 =
//      0, r2 = 0, lanes 0 ... kk-1; :184-220);
//   3. x pre, a full (R1, R2, C) table or one broadcast over the lanes
//      (R1, R2, 1) (tload, :222-226);
//   4. the length-L DFT down the axis: with a matrix, one (L, L) matrix or
//      one per r2 (axis 0) or per r1 (axis 1), the direct product summed
//      in a 192-bit accumulator; without one, the shift-twiddle
//      butterflies of fourstep.dft_axis0 (fourstep.py:339-389): a radix-2
//      DIF of log2 L levels, a + b and (a - b) * 2^e with e = 192/(2m) * j
//      (every L-th root of unity is a power of two, ord(2) = 192), DIF
//      order out; inverse, the mirrored DIT, b * 2^(96 - e) = -b * 2^-e,
//      whose sign swaps the two outputs for j > 0. L must divide 64;
//   5. x post (full or broadcast);
//   6. canon: double where er + ec >= n (with residues), then reduce to
//      [0, P).
// The array is viewed as (O, L, S, C) as in axis_dft.cuh (axis 0: O = 1,
// L = R1, S = R2; axis 1: O = R1, L = R2, S = 1). A block takes one (o, s)
// and a slab of AX_TC columns, stages the slab (and the matrix, where
// matrix and slab fit in a block's shared memory; otherwise each thread
// reads its row of the matrix through the read-only path) after steps
// 1-3, then forms the outputs; the butterflies run on the slab in shared
// memory with a barrier per level. Every input of a block is staged before
// it writes, so the kernel runs in place (out == x).
//
// What bounds it on the H100: the bytes. The matrix form does L + 2 mod-P
// products per digit (66 at L = 64), the shift form 2 products and log2 L
// / 2 shifted reductions, against 24 bytes of device traffic per digit
// (x in and out, a full pre or post table). A simple kernel first: one
// thread per column of the slab, eight rows of threads.

#include <cuda_runtime.h>

#include "axis_dft.cuh"

struct PassArgs {
    const u64* x;
    u64* out;
    const u64* pre;        // null: none
    const u64* post;       // null: none
    int pre_bcast;         // 1: (rows, 1) table, one word per (o, j, s)
    int post_bcast;
    const u64* mats;       // null: shift butterflies
    int var_o, var_s;      // matrix index = o * var_o + s * var_s
    int gm;                // 1: the matrix read from device memory
    int inverse;
    u64 cin;
    const u32* widths;     // kk spread widths; kk = 0: no injection
    int kk;
    const u32* er;         // null: no wrap correction
    const u32* ec;
    u32 n;
    int canon;
    int O, L, S, C;
};

namespace {

__device__ __forceinline__ bool pass_wrap(const PassArgs& g, size_t row,
                                          int c) {
    return g.er != nullptr && g.er[row] + g.ec[c] >= g.n;
}

__global__ void __launch_bounds__(AX_TC * AX_TY) k4u_pass_kernel(PassArgs g) {
    extern __shared__ u64 smem[];
    const int L = g.L, S = g.S, C = g.C;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * AX_TC + tx;
    const int o = blockIdx.z, s = blockIdx.y;
    const int c = blockIdx.x * AX_TC + tx;
    const bool mat = g.mats != nullptr;
    const u64* M = mat ? g.mats + (size_t)(o * g.var_o + s * g.var_s) * L * L
                       : nullptr;
    const bool staged = mat && !g.gm;
    u64* xs = staged ? smem + L * L : smem;
    if (staged)
        for (int i = tid; i < L * L; i += AX_TC * AX_TY) smem[i] = M[i];

    for (int j = ty; j < L; j += AX_TY) {
        const size_t row = (size_t)(o * L + j) * S + s;
        const size_t idx = row * C + c;
        u64 v = g.x[idx];
        if (!g.canon && pass_wrap(g, row, c)) v = gl_halve(v);
        if (g.kk > 0 && row == 0 && c < g.kk) {
            int q = 0;
            for (int i = 0; i < c; ++i) q += (int)g.widths[i];
            u32 part = q < 64 ? (u32)(g.cin >> q) : 0u;
            if (c < g.kk - 1) part &= (1u << g.widths[c]) - 1u;
            v += part;
        }
        if (g.pre != nullptr)
            v = gl_mul(v, g.pre[g.pre_bcast ? row : idx]);
        xs[j * AX_TC + tx] = v;
    }
    __syncthreads();

    if (!mat) {
        // levels of half-size m: L/2 butterflies per column, spread over
        // the AX_TY rows of threads; forward m = L/2 ... 1, inverse the
        // mirror 1 ... L/2
        for (int lv = 0; (1 << lv) < L; ++lv) {
            const int m = g.inverse ? (1 << lv) : (L >> (lv + 1));
            const int step = 192 / (2 * m);
            for (int q = ty; q < L / 2; q += AX_TY) {
                const int jj = q % m;
                const int ia = (q / m) * 2 * m + jj;
                const int ib = ia + m;
                const int e = step * jj;
                const u64 a = xs[ia * AX_TC + tx];
                const u64 b = xs[ib * AX_TC + tx];
                if (!g.inverse) {
                    xs[ia * AX_TC + tx] = gl_add(a, b);
                    const u64 d = gl_sub(a, b);
                    xs[ib * AX_TC + tx] = e ? gl_shiftmul(d, e) : d;
                } else {
                    const u64 bt = e ? gl_shiftmul(b, 96 - e) : b;
                    const u64 sm = gl_add(a, bt);
                    const u64 df = gl_sub(a, bt);
                    xs[ia * AX_TC + tx] = jj ? df : sm;
                    xs[ib * AX_TC + tx] = jj ? sm : df;
                }
            }
            __syncthreads();
        }
    }

    for (int k = ty; k < L; k += AX_TY) {
        const size_t row = (size_t)(o * L + k) * S + s;
        const size_t idx = row * C + c;
        u64 v;
        if (mat) {
            const u64* Mk = (staged ? smem : M) + (size_t)k * L;
            GlAcc sum = gl_acc_zero();
            for (int j = 0; j < L; ++j)
                gl_acc_madd(sum, staged ? Mk[j] : __ldg(Mk + j),
                            xs[j * AX_TC + tx]);
            v = gl_acc_reduce(sum);
        } else {
            v = xs[k * AX_TC + tx];
        }
        if (g.post != nullptr)
            v = gl_mul(v, g.post[g.post_bcast ? row : idx]);
        if (g.canon) {
            if (pass_wrap(g, row, c)) v = gl_double(v);
            v = gl_canon(v);
        }
        g.out[idx] = v;
    }
}

}  // namespace

// One pass over the whole (O, L, S, C) array; returns cudaGetLastError(),
// or -1 for a shape the kernel does not take (C not a multiple of AX_TC, a
// shift length that does not divide 64, a slab beyond a block's shared
// memory).
extern "C" int prmers_k4u_pass(const u64* x, u64* out, const u64* pre,
                               int pre_bcast, const u64* post,
                               int post_bcast, const u64* mats, int var_o,
                               int var_s, int inverse, u64 cin,
                               const u32* widths, int kk, const u32* er,
                               const u32* ec, u32 n, int canon, int O, int L,
                               int S, int C, void* stream) {
    if (C % AX_TC || L < 1 || kk < 0 || kk > C) return -1;
    if (mats == nullptr && (L > 64 || 64 % L)) return -1;
    PassArgs g = {x, out, pre, post, pre_bcast, post_bcast, mats, var_o,
                  var_s, 0, inverse, cin, widths, kk, er, ec, n, canon,
                  O, L, S, C};
    const size_t slab = (size_t)L * AX_TC * sizeof(u64);
    size_t smem = slab;
    if (mats != nullptr) {
        const size_t whole = slab + (size_t)L * L * sizeof(u64);
        if (whole <= AX_SMEM_MAX)
            smem = whole;
        else
            g.gm = 1;
    }
    if (smem > AX_SMEM_MAX) return -1;
    cudaError_t err = cudaFuncSetAttribute(
        k4u_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(C / AX_TC, S, O);
    dim3 block(AX_TC, AX_TY);
    k4u_pass_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}
