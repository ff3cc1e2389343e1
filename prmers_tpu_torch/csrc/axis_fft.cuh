// The length-L axis DFT (L = 2^LL, 1 <= L <= 128) of K1, of K2's two r2
// launches, of the two K5 passes at a power-of-two L2, of K3's r1 inverse
// (K3a, the first half of K3's one launch), of both K4 launches and of
// the shift form of K4u / K5u (the unfolded passes, k4u_pass.cu), as
// register-pass shift butterflies with at most two products per digit.
//
// Replaces, on those launches, axis_dft.cuh's dense tile (L full mod-P
// products per digit by the folded matrices k1_mats, k3_mats, g2 and tri),
// which stands for the Pallas kernels _p1c_kernel (prmers_tpu/ops/pallas/
// kernels.py:512), the first half of _p7c_kernel (:612), and _pass_kernel
// (:130) in its axis-0 form (through _axis0_pass :268) and its axis-1
// form (through _axis1_pass :452 and the r2fold stages of _fused_c_kernel
// :991). The same functions, exact mod P, over the (O, L, S, C) view of
// axis_dft.cuh (element (o, j, s, c) at ((o*L + j)*S + s)*C + c, the
// transform over j):
//   AX_K1   y = halve(x + carry parts) * k1_cs[j, s]; the DIF; * k1_rs[k, s]
//           (k1_mats[s] = diag(t_r[:, s]) DFT_L1 diag(wr[:, s]))
//   AX_K4F  the same with the block-carry inject (the first kk digits of
//           r1 block j take block j-1's carry, at s = 0) in place of K1's
//   AX_K2A  the DIF; * mf                            (g2 = DFT_L2)
//   AX_K2C  * mi; the inverse DIT; * t_r_inv[o, k]   (tri[o] = diag(t_r_inv[o])
//                                                     DFT_L2^-1)
//   AX_K3A  the inverse DIT; * k3_rs[k, s]; double where er + ec >= n;
//           canon; optionally * a, canon           (k3_mats[s] = diag(
//           (K3a; K4 inverse with no * a)           k3_rs[:, s]) DFT_L1^-1)
//   AX_K4UF ax_pass_pre (halve where wrapped, the scalar carry's parts, *
//           pre); the DIF; ax_pass_post (* post; with canon the double
//           and the reduction), L <= 64
//   AX_K4UI the same around the inverse DIT
// The DIF is radix 2 in place: a + b and (a - b) w_2m^jj at half-size m,
// jj = j mod m; it leaves frequency bitrev(k) at position k, the DIF order
// of fourstep.dft_matrix, so no permutation is needed. The inverse is the
// mirrored DIT by the inverse roots, DIF order in, natural out. Since
// ord(2) = 192, w_2m = 2^(192/2m) for 2m <= 64 and every twiddle is a
// shift; w_128 = 2^25 (2^48 - 1) with w_128^2 = 2^3, so the first level of
// a 128-point DIF (the last of its inverse) takes gl_mul_w128pow: two
// shifts and a subtraction.
//
// AX_K3A's output is the row carry's input (K3's one launch, k3_p7c.cu;
// K9's k3b_unit), canonical: its double and canon follow the row scale, so
// it equals the dense tile's bit for bit. The double's mask is that of the
// natural-order output row k.
//
// The schedule, for L >= 16 (L <= 8 is one register pass):
//   pass 1  the thread of column c and row ty (0 ... 7) holds the T = L/8
//           values j = ty + 8t in registers (axf_dif_stride) and runs the
//           levels m = L/2 ... 8, whose pairs j, j + m share ty; the
//           exponent (192/2m)(ty + 8 (t mod m/8)) depends on ty and the
//           unrolled t only, and ty is the warp's index, so it is uniform
//           across a warp and never diverges;
//   exchange  the L x 32 words through shared memory, one barrier;
//   pass 2  the thread takes groups of 8 contiguous positions (one at L =
//           64, two at 128, and rows ty < L/8 one each below 64) and runs
//           the levels m = 4, 2, 1 (gl_dif_shift<3>: constant exponents).
// The inverse runs pass 2's levels (gl_dit_shift_inv<3>) on the loaded
// groups first, then the exchange, then pass 1's mirror (axf_dit_stride).
//
// The per-column arithmetic (axf_dif_stride, axf_dit_stride with
// gl64.cuh's gl_dif_shift / gl_dit_shift_inv) is GL_FN, so a host compiler
// builds it (tests/test_torch_axisfft.py holds it to the dense product at
// every L); ops/kernels.axis_fft_model is its torch model. The kernel is
// CUDA only.
//
// The kernel: 256 threads, tx the column (fastest), ty = 0 ... 7. For L >=
// 16 a block owns one (o, s) and 32 consecutive columns, for L <= 8 one
// (o, s) and 256 columns, one per thread; every device access of a warp is
// one 256-byte run of a row. All of a block's loads come before its only
// barrier, and it writes only what it read, so the kernel runs in place
// (out == x), as K2's three launches on one buffer need. Shared memory is
// L x 32 words (16 KiB at L = 64, 32 KiB at 128).
//
// What bounds it on the H100: the bytes, 16 per digit (24 with mf or mi)
// against 1 (K2A, K3A with a = 1) or 2 (K1, K4F, K2C, K3A with a) products
// per digit and log2(L) / 2 shifted reductions. AXF_MOVE is a cut-down
// body for the pass profiler (tools/profile_passes.py --axis): the same
// loads, exchange and stores with an add in place of every product (the
// scales' words read, not the carries or the wrap residues) and no
// butterfly levels; it computes no transform.
#pragma once

#include "gl64.cuh"

// Pass 1's DIF levels m = L/2 ... 8 (L = 2^LL >= 16) on the T = L/8 values
// v[t] = x[ty + 8t] of one column: pairs t, t + m/8; the twiddle w_2m^jj,
// jj = ty + 8 (t mod m/8), a shift below m = 64 (192/2m * jj < 96) and
// gl_mul_w128pow at m = 64.
template <int LL>
GL_FN void axf_dif_stride(u64* v, int ty) {
    constexpr int T = 1 << (LL - 3);
#pragma unroll
    for (int lm = LL - 1; lm >= 3; --lm) {
        const int mt = 1 << (lm - 3);
#pragma unroll
        for (int q = 0; q < T / 2; ++q) {
            const int tt = q & (mt - 1);
            const int ia = ((q >> (lm - 3)) << (lm - 2)) + tt;
            const int jj = ty + 8 * tt;
            const u64 a = v[ia], b = v[ia + mt];
            const u64 d = gl_sub(a, b);
            v[ia] = gl_add(a, b);
            v[ia + mt] = lm == 6 ? gl_mul_w128pow(d, jj)
                                 : gl_shiftmul(d, (192 >> (lm + 1)) * jj);
        }
    }
}

// Its inverse mirror, the DIT levels m = 8 ... L/2 by the inverse roots: a
// + b w_2m^-jj and a - b w_2m^-jj, with b 2^-e = -b 2^(96 - e) (e = 0: a +
// b, a - b) below m = 64 and gl_mul_w128pow(b, -jj) at m = 64.
template <int LL>
GL_FN void axf_dit_stride(u64* v, int ty) {
    constexpr int T = 1 << (LL - 3);
#pragma unroll
    for (int lm = 3; lm < LL; ++lm) {
        const int mt = 1 << (lm - 3);
#pragma unroll
        for (int q = 0; q < T / 2; ++q) {
            const int tt = q & (mt - 1);
            const int ia = ((q >> (lm - 3)) << (lm - 2)) + tt;
            const int jj = ty + 8 * tt;
            const u64 a = v[ia], b = v[ia + mt];
            if (lm == 6) {
                const u64 t = gl_mul_w128pow(b, -jj);
                v[ia] = gl_add(a, t);
                v[ia + mt] = gl_sub(a, t);
            } else {
                const int e = (192 >> (lm + 1)) * jj;
                if (e == 0) {
                    v[ia] = gl_add(a, b);
                    v[ia + mt] = gl_sub(a, b);
                } else {
                    const u64 t = gl_shiftmul(b, 96 - e);
                    v[ia] = gl_sub(a, t);
                    v[ia + mt] = gl_add(a, t);
                }
            }
        }
    }
}

#if defined(__CUDACC__)

#include "axis_dft.cuh"

// The kernel's body: the whole pass, or the pass profiler's move-only one.
enum { AXF_FULL = 0, AXF_MOVE = 1 };
#define AXF_COLS_SMALL (AX_TC * AX_TY)   // columns per block at L <= 8

namespace {

// K4 forward's prologue of element (j, s, c) of the (1, L, S, C) view
// before its scale: r1 block j starts at (j, s = 0, c = 0) and takes block
// j-1's carry (block 0 the last one's), the roll folded in as in K1,
// spread over its first kk digits; inject before the halve, as the JAX
// block pipeline's XLA strip runs before its P1. No carries (co null: the
// hybrid's K4), no inject.
__device__ __forceinline__ u64 axf_k4_inject_halve(const AxisArgs& g, int j,
                                                   int s, int c, u64 v) {
    if (g.co != nullptr && s == 0 && c < g.kk) {
        const u64 cin = g.co[(j + g.L - 1) % g.L];
        const u32 cm = g.cum[j * g.kk + c];
        u32 part = cm < 64 ? (u32)(cin >> cm) : 0u;
        if (c < g.kk - 1) part &= (1u << g.wt[j * g.kk + c]) - 1u;
        v += part;
    }
    if (g.er[j * g.S + s] + g.ec[c] >= g.n) v = gl_halve(v);
    return v;
}

// The prologue of element (o, j, s, c) at idx: K1's and K4F's carry parts,
// halve and x k1_cs[j, s]; K2C's x mi; K4u / K5u's ax_pass_pre; K2A and
// K3A none. AXF_MOVE reads the same table words and adds them.
template <int MODE, int PART>
__device__ __forceinline__ u64 axf_pre(const AxisArgs& g, u64 v, int o,
                                       int j, int s, int c, size_t idx) {
    if (MODE == AX_K4UF || MODE == AX_K4UI)
        return ax_pass_pre(g, o, j, s, c, v);
    if (MODE == AX_K2A || MODE == AX_K3A) return v;
    const u64 f = MODE == AX_K2C ? g.tab[idx] : g.cs[j * g.S + s];
    if (PART == AXF_MOVE) return gl_add(v, f);
    if (MODE == AX_K1) v = ax_k1_inject_halve(g, j, s, c, v);
    if (MODE == AX_K4F) v = axf_k4_inject_halve(g, j, s, c, v);
    return gl_mul(v, f);
}

// The epilogue of output (o, k, s, c) at idx: x k1_rs[k, s] (K1, K4F), x mf
// (K2A), x t_r_inv[o, k] (K2C), or K3A's x k3_rs[k, s], double where the
// output row's weight wraps, canon and, with with_a (uniform over the
// grid), x a and canon: canonical out, as the row carry takes it; K4u /
// K5u's ax_pass_post.
template <int MODE, int PART>
__device__ __forceinline__ u64 axf_post(const AxisArgs& g, u64 v, int o,
                                        int k, int s, int c, size_t idx) {
    if (MODE == AX_K4UF || MODE == AX_K4UI)
        return ax_pass_post(g, o, k, s, c, v);
    const u64 f = MODE == AX_K2A   ? g.tab[idx]
                  : MODE == AX_K2C ? g.rs[o * g.L + k]
                                   : g.rs[k * g.S + s];
    if (PART == AXF_MOVE) return gl_add(v, f);
    v = gl_mul(v, f);
    if (MODE == AX_K3A) {
        if (g.er[k * g.S + s] + g.ec[c] >= g.n) v = gl_double(v);
        v = gl_canon(v);
        if (g.with_a) v = gl_canon(gl_mul(v, g.a));
    }
    return v;
}

// The inverse tile at L >= 16 up to its epilogue: the loads, the prologue
// and pass 2's levels on each group, the exchange, pass 1's mirror. After
// it the thread (tx, ty) holds in v[t] output row k = ty + 8t of column cb
// * AX_TC + tx, so row k's 32 columns are the lanes of warp ty. Its one
// barrier follows all of its loads. axis_fft_tile stores the values after
// axf_post; K3's one launch (k3_p7c.cu) runs the row carry on them first.
template <int MODE, int LL, int PART>
__device__ __forceinline__ void axf_inv_values(const AxisArgs& g, int o,
                                               int s, int cb, int tx, int ty,
                                               u64* xs, u64* v) {
    constexpr int L = 1 << LL;
    constexpr int T = L / 8;
    constexpr int G = T >= 8 ? T / 8 : 1;
    constexpr bool LEVELS = PART == AXF_FULL;
    static_assert(LL >= 4, "one register pass below L = 16");
    const int c = cb * AX_TC + tx;
    const size_t base = ((size_t)o * L * g.S + s) * g.C + c;
    const size_t rs = (size_t)g.S * g.C;
    if (T >= 8 || ty < T) {
        u64 w[G][8];
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
            for (int i = 0; i < 8; ++i)
                w[gi][i] = g.x[base + (8 * (ty + 8 * gi) + i) * rs];
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
            const int j0 = 8 * (ty + 8 * gi);
#pragma unroll
            for (int i = 0; i < 8; ++i)
                w[gi][i] = axf_pre<MODE, PART>(g, w[gi][i], o, j0 + i, s, c,
                                               base + (j0 + i) * rs);
            if constexpr (LEVELS) gl_dit_shift_inv<3>(w[gi], 1);
#pragma unroll
            for (int i = 0; i < 8; ++i) xs[(j0 + i) * AX_TC + tx] = w[gi][i];
        }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < T; ++t) v[t] = xs[(ty + 8 * t) * AX_TC + tx];
    if constexpr (LEVELS) axf_dit_stride<LL>(v, ty);
}

// One tile of the pass: the (o, s) pair and column block cb (32 columns
// from cb * 32 for L >= 16, 256 from cb * 256 for L <= 8), on the thread
// (tx, ty) of AX_TC x AX_TY, with L x AX_TC words of shared memory at xs
// (unused at L <= 8). Its one barrier follows all of its loads, and it
// writes only what it read, so it runs in place. A caller that runs one
// tile after another on the same xs separates them by a barrier (K9 does,
// k9_chain.cu); the standalone kernel runs one tile per block.
template <int MODE, int LL, int PART>
__device__ __forceinline__ void axis_fft_tile(const AxisArgs& g, int o, int s,
                                              int cb, int tx, int ty,
                                              u64* xs) {
    constexpr int L = 1 << LL;
    constexpr bool INV =
        MODE == AX_K2C || MODE == AX_K3A || MODE == AX_K4UI;
    constexpr bool LEVELS = PART == AXF_FULL;
    const int S = g.S, C = g.C;
    if constexpr (LL <= 3) {
        // one register pass: the thread's whole column
        const int c = cb * AXF_COLS_SMALL + ty * AX_TC + tx;
        u64 v[L];
        size_t idx[L];
#pragma unroll
        for (int j = 0; j < L; ++j) {
            idx[j] = ((size_t)(o * L + j) * S + s) * C + c;
            v[j] = g.x[idx[j]];
        }
#pragma unroll
        for (int j = 0; j < L; ++j)
            v[j] = axf_pre<MODE, PART>(g, v[j], o, j, s, c, idx[j]);
        if constexpr (LEVELS && INV) gl_dit_shift_inv<LL>(v, 1);
        if constexpr (LEVELS && !INV) gl_dif_shift<LL>(v, 1);
#pragma unroll
        for (int k = 0; k < L; ++k)
            g.out[idx[k]] = axf_post<MODE, PART>(g, v[k], o, k, s, c, idx[k]);
    } else {
        constexpr int T = L / 8;            // pass-1 values per thread
        constexpr int G = T >= 8 ? T / 8 : 1;  // pass-2 groups per thread
        const int c = cb * AX_TC + tx;
        const size_t base = ((size_t)o * L * S + s) * C + c;
        const size_t rs = (size_t)S * C;    // one step of j
        if constexpr (!INV) {
            // pass 2 runs on rows ty < T only where a row has no full group
            const bool grp = T >= 8 || ty < T;
            u64 v[T];
#pragma unroll
            for (int t = 0; t < T; ++t) v[t] = g.x[base + (ty + 8 * t) * rs];
#pragma unroll
            for (int t = 0; t < T; ++t) {
                const int j = ty + 8 * t;
                v[t] = axf_pre<MODE, PART>(g, v[t], o, j, s, c, base + j * rs);
            }
            if constexpr (LEVELS) axf_dif_stride<LL>(v, ty);
#pragma unroll
            for (int t = 0; t < T; ++t) xs[(ty + 8 * t) * AX_TC + tx] = v[t];
            __syncthreads();
            if (grp) {
#pragma unroll
                for (int gi = 0; gi < G; ++gi) {
                    const int k0 = 8 * (ty + 8 * gi);
                    u64 w[8];
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                        w[i] = xs[(k0 + i) * AX_TC + tx];
                    if constexpr (LEVELS) gl_dif_shift<3>(w, 1);
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        const size_t idx = base + (k0 + i) * rs;
                        g.out[idx] = axf_post<MODE, PART>(g, w[i], o, k0 + i,
                                                          s, c, idx);
                    }
                }
            }
        } else {
            u64 v[T];
            axf_inv_values<MODE, LL, PART>(g, o, s, cb, tx, ty, xs, v);
#pragma unroll
            for (int t = 0; t < T; ++t) {
                const int k = ty + 8 * t;
                const size_t idx = base + k * rs;
                g.out[idx] = axf_post<MODE, PART>(g, v[t], o, k, s, c, idx);
            }
        }
    }
}

template <int MODE, int LL, int PART>
__global__ void __launch_bounds__(AX_TC * AX_TY) axis_fft_kernel(AxisArgs g) {
    __shared__ u64 xs[LL <= 3 ? 1 : (1 << LL) * AX_TC];
    axis_fft_tile<MODE, LL, PART>(g, blockIdx.z, blockIdx.y, blockIdx.x,
                                  threadIdx.x, threadIdx.y, xs);
}

template <int MODE, int LL, int PART>
static int axf_launch(const AxisArgs& g, cudaStream_t stream) {
    const int cols = LL <= 3 ? AXF_COLS_SMALL : AX_TC;
    if (g.C % cols) return -1;
    dim3 grid(g.C / cols, g.S, g.O);
    dim3 block(AX_TC, AX_TY);
    axis_fft_kernel<MODE, LL, PART><<<grid, block, 0, stream>>>(g);
    return (int)cudaGetLastError();
}

}  // namespace

// One pass over the whole (O, L, S, C) array; returns cudaGetLastError(),
// or -1 for a shape the kernel does not take (L not a power of two up to
// 128, or above 64 for the r1 axis of K1, K3A and K4F, which never exceeds
// 64; C not a multiple of the block's columns). The move-only body is
// built for L = 64 and 128 alone, the lengths the profiler times.
template <int MODE, int PART = AXF_FULL>
static int axis_fft_launch(const AxisArgs& g, cudaStream_t stream) {
    constexpr bool L128 = MODE == AX_K2A || MODE == AX_K2C;
    if constexpr (PART == AXF_MOVE) {
        if (g.L == 64) return axf_launch<MODE, 6, AXF_MOVE>(g, stream);
        if constexpr (L128)
            if (g.L == 128) return axf_launch<MODE, 7, AXF_MOVE>(g, stream);
        return -1;
    } else {
        switch (g.L) {
        case 1: return axf_launch<MODE, 0, AXF_FULL>(g, stream);
        case 2: return axf_launch<MODE, 1, AXF_FULL>(g, stream);
        case 4: return axf_launch<MODE, 2, AXF_FULL>(g, stream);
        case 8: return axf_launch<MODE, 3, AXF_FULL>(g, stream);
        case 16: return axf_launch<MODE, 4, AXF_FULL>(g, stream);
        case 32: return axf_launch<MODE, 5, AXF_FULL>(g, stream);
        case 64: return axf_launch<MODE, 6, AXF_FULL>(g, stream);
        case 128:
            if constexpr (L128)
                return axf_launch<MODE, 7, AXF_FULL>(g, stream);
            return -1;
        }
        return -1;
    }
}

#endif  // __CUDACC__
