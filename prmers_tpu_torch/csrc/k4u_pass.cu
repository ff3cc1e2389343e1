// K4u and K5u: the unfolded r passes, down axis 0 (r1, K4u) or axis 1
// (r2, K5u) of the (R1, R2, C) register, in one entry point as the Pallas
// kernel has one body.
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_pass_kernel (:130) in the
// forms that _forward_r and _inverse_r (:1530-1571) take, launched by
// _axis0_pass (pallas_call :365) and _axis1_pass (pallas_call :452). Per
// element, in the Pallas kernel's order (axis_dft.cuh's ax_pass_pre and
// ax_pass_post): halve where wrapped (not with canon), the scalar carry's
// parts into digits 0 ... kk-1, x pre (full or one word per row); the
// length-L DFT down the axis; x post; with canon the double where wrapped
// and the reduction to [0, P). Over the (O, L, S, C) view of axis_dft.cuh
// (axis 0: O = 1, L = R1, S = R2; axis 1: O = R1, L = R2, S = 1).
//
// Two forms, as the reference's:
//   shift   (no matrix; L divides 64) the shift-twiddle butterflies on
//           axis_fft.cuh's register passes, modes AX_K4UF / AX_K4UI;
//   matrix  the reference's own design (mxu_dft.py:1-35, mxu_dft_apply
//           :488): one int8 product per (o, s) on the tensor cores,
//           D = W8 @ X, W8 the (Mp, Kp) balanced-limb table of the
//           matrix (ops/mxu_tables.py: one per r2 on axis 0 (var_s), per
//           r1 on axis 1 (var_o), or one for all), X the bytes of the
//           words XOR 0x80, then each output's eight planes + corr
//           combined into a lazy word mod P (s8_dft.cuh), then post.
//
// The matrix form's block (k4u_s8_kernel): one (o, s) and TN = 32 NT
// columns (NT = 2, 64 columns, where C allows), 8 warps as 2 (rows) x 4
// (columns), each warp 64 table rows (eight outputs) by 8 NT columns
// (s8_mma.cuh). It copies corr to shared memory and stages its slab:
// each word of rows j < L after ax_pass_pre, packed (s8_pack_word) and
// stored transposed, column-major: column c's Kp contraction bytes at c *
// (Kp + 16) (the pitch an odd number of 16-byte units: conflict-free
// ldmatrix and 16-byte stores), the padding words j >= L zero; S8P_U
// pairs of words a thread at a time, every load issued before the first
// use. Then each warp row streams its own 64-row tiles of the table (rows
// 128 i + 64 wm) through its own ring of S8P_STAGES stages of 64 rows x
// 128 contraction bytes (cp.async, 16 bytes each, pitch 144) and syncs
// its four warps alone (a named barrier): a chunk is 64 mma.sync a warp,
// and the next chunk's loads (L2 holds the tables) land during it. At the
// last chunk of a tile each warp combines its outputs in registers (lane
// g holds all eight planes of output 8T + g: the table's rows are (r >>
// 3) * 64 + m * 8 + (r & 7)), loads every post word before its first
// store, and stores two adjacent columns per 16-byte store. The whole
// slab is staged before any store, and a block stores only the columns it
// read, so the pass runs in place (out == x).
//
// What bounds it on the H100: at L = 64 the int8 work, 64 L n MACs (2^23
// words: 3.4e10, 0.035 ms at 1,979 TOP/s), against 24 bytes of device
// traffic a word with a full pre or post table (0.060 ms at 2^23). What
// holds it back: the prologue's loads and product, the chunk loop and the
// combine run one after another in a block; they overlap only across a
// block's residents (three an SM at L = 64: at most 80 registers a
// thread, 71 KB of shared memory), and mma.sync reaches a fraction of the
// int8 rate that wgmma does.

#include <cuda_runtime.h>

#include "axis_fft.cuh"
#include "s8_dft.cuh"
#include "s8_mma.cuh"

#define S8P_THREADS 256
#define S8P_KC 128                // contraction bytes of a ring stage
#define S8P_STAGES 2
#define S8P_AP (S8P_KC + 16)      // a stage's row pitch
#define S8P_U 8                   // slab pairs a thread loads at once

struct S8Tab {
    const signed char* w8;  // (V, Kp, Kp) int8, the device layout
    const int* corr;        // (V, Kp)
    int kp;
    int var_o, var_s;       // table index = o * var_o + s * var_s
};

namespace {

// the slab, the two rings, and corr (kp int32)
template <int NT>
size_t s8p_smem(int kp) {
    return (size_t)32 * NT * (kp + 16) +
           (size_t)2 * S8P_STAGES * 64 * S8P_AP + (size_t)4 * kp;
}

// Three blocks an SM at L <= 64: at most 80 registers a thread.
template <int NT>
__global__ void __launch_bounds__(S8P_THREADS, 3)
    k4u_s8_kernel(AxisArgs g, S8Tab m) {
    constexpr int TN = 32 * NT;
    extern __shared__ __align__(16) unsigned char smem[];
    const int kp = m.kp, bp = kp + 16;
    unsigned char* bs = smem;                       // TN x bp
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3;
    // each warp row streams its own 64-row tiles through its own ring
    unsigned char* ring = smem + (size_t)TN * bp +
                          (size_t)wm * S8P_STAGES * 64 * S8P_AP;
    int* cs = (int*)(smem + (size_t)TN * bp +
                     (size_t)2 * S8P_STAGES * 64 * S8P_AP);
    const int o = blockIdx.z, s = blockIdx.y, c0 = blockIdx.x * TN;
    const int v = o * m.var_o + s * m.var_s;
    const signed char* W = m.w8 + (size_t)v * kp * kp;
    const int nk = kp / S8P_KC;
    const int total = (kp / 128) * nk;

    // chunk q = (this row's tile 2 (q / nk) + wm, chunk q % nk) into its
    // stage by the row's 128 threads; each commits a group per call, so
    // the waits count alike
    auto issue = [&](int q) {
        if (q < total) {
            const int r0 = (q / nk) * 128 + 64 * wm, k0 = (q % nk) * S8P_KC;
            unsigned char* dst = ring + (q % S8P_STAGES) * 64 * S8P_AP;
            for (int t = tid & 127; t < 64 * (S8P_KC / 16); t += 128) {
                const int r = t / (S8P_KC / 16), u = t % (S8P_KC / 16);
                s8_cp_async16(dst + r * S8P_AP + 16 * u,
                              W + (size_t)(r0 + r) * kp + k0 + 16 * u, 16);
            }
        }
        s8_cp_commit();
    };
#pragma unroll
    for (int q = 0; q < S8P_STAGES - 1; ++q) issue(q);

    for (int i = tid; i < kp; i += S8P_THREADS)
        cs[i] = m.corr[(size_t)v * kp + i];
    // the slab: words (j, j + 1) of column c in one 16-byte store; S8P_U
    // pairs a thread at a time, every load issued before the first use
    const int L = g.L;
    const size_t rs = (size_t)g.S * g.C;
    const int pairs = TN * (kp / 16);
    for (int t0 = tid; t0 < pairs; t0 += S8P_U * S8P_THREADS) {
        u64 w[S8P_U][2];
#pragma unroll
        for (int u = 0; u < S8P_U; ++u) {
            const int t = t0 + u * S8P_THREADS;
            const int c = t % TN, j = 2 * (t / TN);
            const size_t base =
                ((size_t)(o * L + j) * g.S + s) * g.C + c0 + c;
            w[u][0] = t < pairs && j < L ? g.x[base] : 0ULL;
            w[u][1] = t < pairs && j + 1 < L ? g.x[base + rs] : 0ULL;
        }
#pragma unroll
        for (int u = 0; u < S8P_U; ++u) {
            const int t = t0 + u * S8P_THREADS;
            const int c = t % TN, j = 2 * (t / TN);
#pragma unroll
            for (int h = 0; h < 2; ++h)
                w[u][h] = j + h < L ? s8_pack_word(ax_pass_pre(
                                          g, o, j + h, s, c0 + c, w[u][h]))
                                    : 0ULL;
        }
#pragma unroll
        for (int u = 0; u < S8P_U; ++u) {
            const int t = t0 + u * S8P_THREADS;
            if (t < pairs)
                *(ulonglong2*)(bs + (size_t)(t % TN) * bp + 16 * (t / TN)) =
                    make_ulonglong2(w[u][0], w[u][1]);
        }
    }

    __syncthreads();                             // the slab, for all
    int acc[4][NT][4];
    s8_zero<NT>(acc);
    const S8Pitch la{S8P_AP}, lb{bp};
    const int gq = lane >> 2, tq = lane & 3;
    const unsigned char* b = bs + (size_t)(8 * NT * wn) * bp;
    for (int q = 0; q < total; ++q) {
        s8_cp_wait<S8P_STAGES - 2>();
        // the row's four warps alone: its chunk q has landed, and its
        // stage (q - 1) % S8P_STAGES is free for chunk q + S8P_STAGES - 1
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wm));
        issue(q + S8P_STAGES - 1);
        const int kc = q % nk;
        const int tile = 2 * (q / nk) + wm;      // this warp's 64-row tile
        const unsigned char* a = ring + (q % S8P_STAGES) * 64 * S8P_AP;
#pragma unroll
        for (int ks = 0; ks < S8P_KC / 32; ++ks)
            s8_warp_k32<NT>(acc, a, la, 2 * ks, b, lb,
                            (kc * S8P_KC) / 16 + 2 * ks, lane);
        if (kc == nk - 1) {
            const int r = 8 * tile + gq;         // this lane's output
            if (r < L) {
                u32 cr[8];
#pragma unroll
                for (int pm = 0; pm < 8; ++pm)
                    cr[pm] = (u32)cs[64 * tile + 8 * pm + gq];
                const size_t row = (size_t)(o * L + r) * g.S + s;
                const int cw = c0 + 8 * NT * wn + 2 * tq;
                u64 y[NT][2];
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        u32 d[8];
#pragma unroll
                        for (int pm = 0; pm < 8; ++pm)
                            d[pm] = (u32)acc[pm >> 1][nt][2 * (pm & 1) + h] +
                                    cr[pm];
                        y[nt][h] = s8_combine(d);
                    }
                // every post and wrap load before the first store
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        y[nt][h] = ax_pass_post(g, o, r, s, cw + 8 * nt + h,
                                                y[nt][h]);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
                    *(ulonglong2*)(g.out + row * g.C + cw + 8 * nt) =
                        make_ulonglong2(y[nt][0], y[nt][1]);
            }
            s8_zero<NT>(acc);
        }
    }
    s8_cp_wait<0>();
}

template <int NT>
int s8p_launch(const AxisArgs& g, const S8Tab& m, cudaStream_t stream) {
    const size_t smem = s8p_smem<NT>(m.kp);
    cudaError_t err = cudaFuncSetAttribute(
        k4u_s8_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(g.C / (32 * NT), g.S, g.O);
    k4u_s8_kernel<NT><<<grid, S8P_THREADS, smem, stream>>>(g, m);
    return (int)cudaGetLastError();
}

}  // namespace

// One pass over the whole (O, L, S, C) array, in place when out == x: the
// matrix form when w8 is given (the device tables of ops/mxu_tables.py,
// kp = 128 ceil(L / 16)), else the shift form. Returns cudaGetLastError(),
// or -1 for a shape the kernel does not take: the shift form at an L that
// does not divide 64 or a C that is not a multiple of its block's columns
// (32; 256 at L <= 8); the matrix form at a kp that is not L's or a C with
// no column tile (32 NT, NT = 2, 1, the widest whose slab fits a block's
// shared memory beside the rings).
extern "C" int prmers_k4u_pass(const u64* x, u64* out, const u64* pre,
                               int pre_bcast, const u64* post,
                               int post_bcast, const signed char* w8,
                               const int* corr, int kp, int var_o, int var_s,
                               int inverse, u64 cin, const u32* widths,
                               int kk, const u32* er, const u32* ec, u32 n,
                               int canon, int O, int L, int S, int C,
                               void* stream) {
    if (L < 1 || kk < 0 || kk > C || C < 1) return -1;
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.wt = widths;
    g.kk = kk;
    g.er = er;
    g.ec = ec;
    g.n = n;
    g.O = O;
    g.L = L;
    g.S = S;
    g.C = C;
    g.pre = pre;
    g.post = post;
    g.pre_bcast = pre_bcast;
    g.post_bcast = post_bcast;
    g.cin = cin;
    g.canon = canon;
    cudaStream_t st = (cudaStream_t)stream;
    if (w8 == nullptr) {
        if (L > 64 || 64 % L) return -1;
        return inverse ? axis_fft_launch<AX_K4UI>(g, st)
                       : axis_fft_launch<AX_K4UF>(g, st);
    }
    if (corr == nullptr || kp != 128 * ((L + 15) / 16)) return -1;
    const S8Tab m = {w8, corr, kp, var_o, var_s};
    if (C % 64 == 0 && s8p_smem<2>(kp) <= AX_SMEM_MAX)
        return s8p_launch<2>(g, m, st);
    if (C % 32 == 0 && s8p_smem<1>(kp) <= AX_SMEM_MAX)
        return s8p_launch<1>(g, m, st);
    return -1;
}
