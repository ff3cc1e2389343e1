// K9: a chain of up to CHAIN_K squarings x^2 * a_k in one persistent
// cooperative kernel, for the shapes of n = 2^15 ... 2^19 (whole-row carry
// units, (L1, L2) = (32, 1), (64, 1), (64, 2), (64, 4), (64, 8), C = 1024).
// k9_chain.cu is the engine's entry point, k9_part.cu the pass profiler's.
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_chain_kernel (:1755; its
// pallas_call is at :1954, launched by square_chain :1919, gated by chain_ok
// :1895). The Pallas kernel keeps the whole register, the row carries and
// every table in VMEM and loops the squarings on one TPU core. Here the
// grid is a number of 256-thread blocks the card holds at once (the rule
// in k9_launch), launched with cudaLaunchCooperativeKernel so that
// cooperative_groups::this_grid().sync() can separate the phases. Each
// squaring runs the port's own stage boundaries, each phase a grid-stride
// loop over its tiles, all in place on x, and each runs the body of the
// standalone launch of the same stage:
//   1. K1:  inject the rolled row carries, halve, x k1_cs, the r1 DIF,
//           x k1_rs                  (axis_fft.cuh: axis_fft_tile<AX_K1>)
//   2. K2a: the r2 DIF, x mf                     (axis_fft_tile<AX_K2A>)
//   3. the row C-transform with the square, in one of two forms (below)
//   4. K2c: x mi, the r2 inverse DIT, x t_r_inv  (axis_fft_tile<AX_K2C>)
//   5. K3a: the r1 inverse DIT, x k3_rs, double, canon, x a_k if a_k != 1
//                                                (axis_fft_tile<AX_K3A>)
//   6. K3b: the carry, unit out-carries to co    (k3b_carry.cuh)
// with a grid barrier after each. At L2 = 1 (2^15, 2^16) K2a is x mf and
// K2c x mi, x t_r_inv, elementwise: the split row form's lane phases take
// them as they load and store a word, so phases 2 and 4 and their
// barriers go (2-4% faster on an H100, measured in the fused group before
// the split took those shapes). Phase 1 reads the carries phase 6 wrote in the squaring before;
// the barrier after phase 6 orders them. The trip count is a kernel
// argument and the multipliers a_k a device array, so one launch serves
// every chain length. Register, carries and tables stay in device memory;
// at these sizes (4 MiB of digits at 2^19, a few KiB of scales besides mf
// and mi) they stay in the 50 MB L2 between phases. K3a's output is
// canonical, as K3b takes it, so the digits and carries equal the
// three-kernel step's bit for bit.
//
// The row phase's two forms, chosen per shape by k9_split (a rule fixed
// from an A/B on the card, tools/profile_passes --k9: the split at 2^15
// ... 2^18, the group at 2^19):
//   fused: fused_c_row.cuh's fused_c_row_group, K2b's and K6's body, two
//          rows a group, one phase;
//   split: three phases, each item a short chain: the lane DIF of one
//          (row, lane) (cf_lane_item_fwd), each (row, slot) on its own warp
//          (cf_slot_r2_sqr: x cs_f, the 128-point DFT as radix-2 levels,
//          four words a thread, the square, the inverse, x cs_i), the lane
//          DIT (cf_lane_item_inv); two grid barriers more.
// The group is one block's dependent chain, about 29 us on an H100 whether
// 16 groups run (2^15) or 256 (2^19): its threads hold 16 words and 32
// butterflies in pass A. The split's slot unit gives a thread 4 words and
// 14 butterflies each way and spreads the row over every SM.
//
// Tiles: an r1 tile (phases 1, 5) is one (r2, 32 columns): 32 L2 of them;
// an r2 tile (phases 2, 4; L2 <= 8, one register pass) one (r1, 256
// columns): 4 L1; a row group 2 rows: L1 L2 / 2; a split lane item one
// (row, 32 lanes) on a warp: 4 L1 L2, a slot unit 8 L1 L2 on a warp; a
// carry unit one row: L1 L2. Each tile runs in place and writes only what
// it read, so a phase needs no scratch and a block may run one tile after
// another (a block barrier between them, for the shared memory). The
// kernel is built for each (log2 L1, log2 L2), so every phase's levels
// unroll.
//
// What bounds it on the H100: not the work. The mod-P products per digit
// are those of the three-kernel step, 24 at 2^15 and 28 at 2^19 (PERF.md
// section 3: K1 2 + log2(L1)/2, K2a 1 + log2(L2)/2, K2c 2 + log2(L2)/2,
// the C-transform 2 (1 + log2(C)/2), the square, K3a 1 + log2(L1)/2),
// shift butterflies for the rest, microseconds of the card's rate. A
// phase takes the latency of one tile's dependent chain of 64-bit integer
// operations plus a grid barrier (1.3-2.4 us). What the design does
// about it: one launch per chunk of up to 512 squarings instead of six
// grid launches per squaring, no scratch buffer, short chains, and each
// phase's tiles spread over the SMs (k9_place).
//
// The kernel's template also takes the phases it runs (PH, bit p phase p +
// 1; the grid barriers run whatever the set) and a cut-down body, K9_MOVE:
// the same grid, tiles, loads, stores and grid barriers, the axis tiles'
// AXF_MOVE and the row's CF_MOVE bodies (an add in place of every product,
// no butterflies) and K3b whole (it has no product); it computes no
// transform. Only k9_part.cu instantiates those.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "axis_fft.cuh"
#include "fused_c_row.cuh"
#include "k3b_carry.cuh"

namespace cg = cooperative_groups;

// Internal linkage: k9_chain.cu and k9_part.cu each instantiate the kernel.
namespace {

#define K9_THREADS 256
#define K9_LCA 3         // C = 128 << 3 = 1024
#define K9_C (128 << K9_LCA)
#define K9_PER 4         // ct = C = 1024 digits per carry unit
#define K9_ROWS 2        // rows per group of the row phase
#define K9_MAX_SMS 1024
#define K9_WARPS (K9_THREADS / 32)

enum { K9_FULL = 0, K9_MOVE = 1 };
enum { K9_ALL = 63 };    // the phase set of the engine: all six

// The row phase's form at each shape (log2 L1, log2 L2): the split up to
// L2 = 4, the fused group at L2 = 8. On an H100 (tools/profile_passes
// --k9, both forms in one call, ms per squaring) the split read 0.0339 /
// 0.0407 / 0.0430 / 0.0474 at 2^15 ... 2^18 against the group's 0.0461 /
// 0.0533 / 0.0540 / 0.0563, and 0.0672 at 2^19 against 0.0654: there its
// two extra barriers cost more than its shorter chains save.
constexpr bool k9_split(int ll1, int ll2) { return ll2 <= 2; }

static_assert(AX_TC * AX_TY == K9_THREADS, "axis tile block size");
static_assert(K3B_THREADS == K9_THREADS, "carry unit block size");
static_assert(CfShape<K9_LCA, K9_ROWS>::NT == K9_THREADS,
              "row group block size");
static_assert(K9_PER * K3B_THREADS == K9_C, "one carry unit per row");

// Shared memory, in words: an r1 tile's L1 x 32 exchange (at most 64 x
// 32), a row group's ROWS x C words, a carry unit's C words, the split's
// 128 words a warp.
constexpr int K9_SMEM_WORDS = CfShape<K9_LCA, K9_ROWS>::E > 64 * AX_TC
                                  ? CfShape<K9_LCA, K9_ROWS>::E
                                  : 64 * AX_TC;
static_assert(K9_SMEM_WORDS >= K9_PER * K3B_THREADS, "carry unit smem");
static_assert(K9_SMEM_WORDS >= 128 * K9_WARPS, "slot unit smem");

struct ChainArgs {
    u64* x;
    u64* co;
    const u64* a;        // (>= count,) multipliers, int64 bit patterns
    int count;
    const u64* k1_cs;
    const u64* k1_rs;
    const u32* wt;
    const u32* cum;
    int kk;
    const u32* er;
    const u32* ec;
    u32 n;
    const u64* mf;
    const u64* mi;
    const u64* t_r_inv;
    const u64* cs_f;
    const u64* cs_i;
    const u64* k3_rs;
    const u32* widths;
    int rounds;
    int sms;             // the card's SM count
};

// Blocks that have taken a place on each SM in the running launch; zero
// between launches (the launch puts it back). K9 is one launch at a time on
// one stream; each entry point's file has its own.
__device__ unsigned int k9_sm_blocks[K9_MAX_SMS];

// This block's place in the grid-stride loops, spread over the SMs: the
// scheduler fills an SM with consecutive blocks before it moves on, so a
// phase of few tiles would queue them on a few SMs. When every SM holds
// the same number of blocks, place (slot on its SM) * sms + smid numbers
// the blocks densely with consecutive places on different SMs; otherwise
// the place is blockIdx.x. Ends with a grid barrier.
__device__ int k9_place(const ChainArgs& g, cg::grid_group& grid) {
    __shared__ int place;
    unsigned int smid = 0, slot = 0;
    if (threadIdx.x == 0) {
        asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
        if (smid < K9_MAX_SMS) slot = atomicAdd(&k9_sm_blocks[smid], 1u);
    }
    grid.sync();
    if (threadIdx.x == 0) {
        const int per = gridDim.x / g.sms;
        bool dense = per * g.sms == (int)gridDim.x && (int)smid < g.sms;
        const volatile unsigned int* held = k9_sm_blocks;
        for (int s = 0; s < g.sms && dense; ++s) dense = held[s] == (unsigned)per;
        place = dense ? (int)(slot * g.sms + smid) : (int)blockIdx.x;
    }
    __syncthreads();
    return place;
}

// The arguments of one axis phase over the (O, L, S, C) view of x, in
// place, with the carry-inject and wrap fields every phase may read and
// the multiplier a (K3a's x a where a != 1). Each phase's arguments are
// built whole: nvcc mis-built a copy of one AxisArgs into another with a
// field changed inside this kernel.
__device__ __forceinline__ AxisArgs axis_args(const ChainArgs& g,
                                              const u64* tab, const u64* cs,
                                              const u64* rs, int O, int L,
                                              int S, u64 a_k) {
    AxisArgs a;
    a.x = g.x;
    a.out = g.x;
    a.tab = tab;
    a.co = g.co;
    a.wt = g.wt;
    a.cum = g.cum;
    a.kk = g.kk;
    a.ct = K9_C;
    a.er = g.er;
    a.ec = g.ec;
    a.n = g.n;
    a.a = a_k;
    a.with_a = a_k != 1ULL;
    a.O = O;
    a.L = L;
    a.S = S;
    a.C = K9_C;
    a.cs = cs;
    a.rs = rs;
    return a;
}

// At least one block per SM: without the second bound ptxas holds the
// kernel to 80 registers and spills; with it, 90-128 and no spill.
template <int LL1, int LL2, int PART, int PH, bool SPLIT>
__global__ void __launch_bounds__(K9_THREADS, 1)
k9_chain_kernel(ChainArgs g) {
    constexpr int L1 = 1 << LL1, R2 = 1 << LL2;
    constexpr int AXP = PART == K9_FULL ? AXF_FULL : AXF_MOVE;
    constexpr int CFP = PART == K9_FULL ? CF_FULL : CF_MOVE;
    constexpr int CA = 1 << K9_LCA;
    constexpr int NB1 = K9_C / AX_TC;           // an r1 tile's column blocks
    constexpr int NB2 = K9_C / AXF_COLS_SMALL;  // an r2 tile's (L2 <= 8)
    constexpr int T1 = NB1 * R2;                // r1 tiles: (r2, block)
    constexpr int T2 = NB2 * L1;                // r2 tiles: (r1, block)
    constexpr int ROWS = L1 * R2;               // rows = carry units
    constexpr int TG = ROWS / K9_ROWS;          // row groups
    // at L2 = 1 the r2 passes are x mf and x mi, x t_r_inv: the split's
    // lane phases take them, and phases 2 and 4 and their barriers go
    constexpr bool FOLD = LL2 == 0 && SPLIT;
    static_assert(LL2 <= 3 && LL1 >= 4, "K9's r2 tiles are one pass");
    extern __shared__ u64 k9_smem[];
    cg::grid_group grid = cg::this_grid();
    const int tid = threadIdx.x, tx = tid % AX_TC, ty = tid / AX_TC;
    const int warp = tid / 32, lane = tid % 32;

    // Each phase builds its arguments where it starts, from the kernel's
    // parameters, so none of them stays live across the squaring. The
    // split's warp items: warp w of the block at place b takes items b +
    // gridDim.x (w + K9_WARPS i), spread over the blocks first.
    const int b0 = k9_place(g, grid);
    const int w0 = b0 + gridDim.x * warp, ws = gridDim.x * K9_WARPS;
    for (int it = 0; it < g.count; ++it) {
        if constexpr ((PH & 1) != 0) {
            const AxisArgs k1 = axis_args(g, nullptr, g.k1_cs, g.k1_rs, 1, L1,
                                          R2, 1);
            for (int i = b0; i < T1; i += gridDim.x) {
                __syncthreads();
                axis_fft_tile<AX_K1, LL1, AXP>(k1, 0, i / NB1, i % NB1, tx,
                                               ty, k9_smem);
            }
        }
        grid.sync();
        if constexpr (!FOLD) {
            if constexpr ((PH & 2) != 0) {
                const AxisArgs k2a = axis_args(g, g.mf, nullptr, nullptr, L1,
                                               R2, 1, 1);
                for (int i = b0; i < T2; i += gridDim.x)
                    axis_fft_tile<AX_K2A, LL2, AXP>(k2a, i / NB2, 0, i % NB2,
                                                    tx, ty, k9_smem);
            }
            grid.sync();
        }
        if constexpr (SPLIT) {
            if constexpr ((PH & 4) != 0)
                for (int c = w0; c < ROWS * 4; c += ws)
                    cf_lane_item_fwd<K9_LCA, CFP, FOLD>(
                        g.x, c / 4, c % 4 * 32 + lane, g.mf);
            grid.sync();
            if constexpr ((PH & 4) != 0)
                for (int u = w0; u < ROWS * CA; u += ws)
                    cf_slot_r2_sqr<CFP>(g.x + (size_t)u * 128,
                                        g.cs_f + u % CA * 128,
                                        g.cs_i + u % CA * 128,
                                        k9_smem + warp * 128, lane);
            grid.sync();
            if constexpr ((PH & 4) != 0)
                for (int c = w0; c < ROWS * 4; c += ws)
                    cf_lane_item_inv<K9_LCA, CFP, FOLD>(
                        g.x, c / 4, c % 4 * 32 + lane, g.mi, g.t_r_inv);
        } else if constexpr ((PH & 4) != 0) {
            for (int r = b0; r < TG; r += gridDim.x) {
                __syncthreads();
                fused_c_row_group<K9_LCA, K9_ROWS, CFP>(
                    g.x, g.x, nullptr, 1, ROW_SQR, 1, g.cs_f, g.cs_i, r,
                    k9_smem, tid);
            }
        }
        grid.sync();
        if constexpr (!FOLD) {
            if constexpr ((PH & 8) != 0) {
                const AxisArgs k2c = axis_args(g, g.mi, nullptr, g.t_r_inv,
                                               L1, R2, 1, 1);
                for (int i = b0; i < T2; i += gridDim.x)
                    axis_fft_tile<AX_K2C, LL2, AXP>(k2c, i / NB2, 0, i % NB2,
                                                    tx, ty, k9_smem);
            }
            grid.sync();
        }
        if constexpr ((PH & 16) != 0) {
            const AxisArgs k3a = axis_args(g, nullptr, nullptr, g.k3_rs, 1,
                                           L1, R2, g.a[it]);
            for (int i = b0; i < T1; i += gridDim.x) {
                __syncthreads();
                axis_fft_tile<AX_K3A, LL1, AXP>(k3a, 0, i / NB1, i % NB1, tx,
                                                ty, k9_smem);
            }
        }
        grid.sync();
        if constexpr ((PH & 32) != 0)
            for (int f = b0; f < ROWS; f += gridDim.x)
                k3b_unit<K9_PER>(g.x, g.co, g.widths, g.rounds, 0, 0ULL, f,
                                 k9_smem, tid);
        grid.sync();
    }
    if (blockIdx.x == 0)
        for (int s = tid; s < K9_MAX_SMS; s += K9_THREADS) k9_sm_blocks[s] = 0;
}

// The grid: every block the occupancy allows (2 per SM at 86-128
// registers), and in the fused form no more than its largest phase's
// tiles or units; the split's warp items fill every block. On an H100,
// against this rule: one block per SM 61% slower at 2^19 (fused), and in
// the split 4% faster at 2^15 but 17% slower at 2^18; the split capped at
// its slot units over 8 warps within 1% (tools/profile_passes --k9 runs
// made while the rule was chosen).
template <int LL1, int LL2, int PART, int PH, bool SPLIT>
int k9_launch(ChainArgs& g, cudaStream_t st) {
    constexpr int L1 = 1 << LL1, R2 = 1 << LL2;
    const void* kern = (const void*)k9_chain_kernel<LL1, LL2, PART, PH, SPLIT>;
    const size_t smem = K9_SMEM_WORDS * sizeof(u64);
    int occ = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, k9_chain_kernel<LL1, LL2, PART, PH, SPLIT>, K9_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    int blocks = occ * g.sms;
    if (!SPLIT) {
        int most = L1 * R2;                                   // carry units
        if (K9_C / AX_TC * R2 > most) most = K9_C / AX_TC * R2;  // r1 tiles
        if (LL2 > 0 && K9_C / AXF_COLS_SMALL * L1 > most)        // r2 tiles
            most = K9_C / AXF_COLS_SMALL * L1;
        if (blocks > most) blocks = most;
    }
    void* args[] = {&g};
    err = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(K9_THREADS),
                                      args, smem, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// f(log2 L1, log2 L2) as std::integral_constant arguments, for each shape
// fourstep.chain_ok admits; -1 for another.
template <class F>
int k9_shape(int L1, int R2, F&& f) {
    using I5 = std::integral_constant<int, 5>;
    using I6 = std::integral_constant<int, 6>;
    if (L1 == 32 && R2 == 1) return f(I5(), std::integral_constant<int, 0>());
    if (L1 != 64) return -1;
    switch (R2) {
    case 1: return f(I6(), std::integral_constant<int, 0>());
    case 2: return f(I6(), std::integral_constant<int, 1>());
    case 4: return f(I6(), std::integral_constant<int, 2>());
    case 8: return f(I6(), std::integral_constant<int, 3>());
    }
    return -1;
}

// The entry points' arguments, checked: 0, or a CUDA error code, or -1 for
// an argument the kernel does not take. No fallback: a card without
// cooperative launch is an error.
int k9_args(ChainArgs& g, u64* x, u64* co, const u64* a, int count,
                   const u64* k1_cs, const u64* k1_rs, const u32* wt,
                   const u32* cum, int kk, const u32* er, const u32* ec,
                   u32 n, const u64* mf, const u64* mi, const u64* t_r_inv,
                   const u64* cs_f, const u64* cs_i, const u64* k3_rs,
                   const u32* widths, int rounds, int C) {
    if (C != K9_C || kk > C || count < 0) return -1;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int coop = 0, sms = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (sms > K9_MAX_SMS) return -1;
    g.x = x;
    g.co = co;
    g.a = a;
    g.count = count;
    g.k1_cs = k1_cs;
    g.k1_rs = k1_rs;
    g.wt = wt;
    g.cum = cum;
    g.kk = kk;
    g.er = er;
    g.ec = ec;
    g.n = n;
    g.mf = mf;
    g.mi = mi;
    g.t_r_inv = t_r_inv;
    g.cs_f = cs_f;
    g.cs_i = cs_i;
    g.k3_rs = k3_rs;
    g.widths = widths;
    g.rounds = rounds;
    g.sms = sms;
    return 0;
}

}  // namespace
