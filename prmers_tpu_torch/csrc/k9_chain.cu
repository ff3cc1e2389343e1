// K9: a chain of up to CHAIN_K squarings x^2 * a_k in one persistent
// cooperative kernel, for the shapes of n = 2^15 ... 2^19 (whole-row carry
// units, L2 <= 8, C = 1024).
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_chain_kernel (:1755; its
// pallas_call is at :1954, launched by square_chain :1919, gated by chain_ok
// :1895). The Pallas kernel keeps the whole register, the row carries and
// every table in VMEM and loops the squarings on one TPU core. Here the
// grid is as many 256-thread blocks as the card holds at once (the
// occupancy for this kernel and its shared memory, times the SM count,
// capped at the largest tile count of any phase), launched with
// cudaLaunchCooperativeKernel so that cooperative_groups::this_grid().sync()
// can separate the phases. Each squaring runs the port's own stage
// boundaries, each phase a grid-stride loop over its tiles, moving the
// register between x and a scratch S of the same size:
//   1. K1:  inject the rolled row carries, halve, r1 DFT;
//           x -> S                                        (axis_dft.cuh)
//   2. K2a: the r2 DFT, then x mf; S in place             (axis_dft.cuh)
//   3. K2b: per (rows, slot): that slot of the lane DFT, the Mf slot
//           product, the square, the Mi slot product; S -> x
//                                                         (fused_c_row.cuh)
//   4. K2b: per row: the inverse lane DFT; x -> S         (fused_c_row.cuh)
//   5. K2c: x mi, then the r2 inverse; S in place         (axis_dft.cuh)
//   6. K3a: r1 inverse, double, canon, x a_k if a_k != 1;
//           S -> x                                        (axis_dft.cuh)
//   7. K3b: the carry, unit out-carries to co; x in place (k3b_carry.cuh)
// with a grid barrier after each. The trip count is a kernel argument and
// the multipliers a_k a device array, so one launch serves every chain
// length. Register, scratch, carries and tables stay in device memory; at
// these sizes (4 MiB of digits at 2^19, under 1 MiB of tables besides the
// 2 x 1 MiB slot matrices) they stay in the 50 MB L2 between phases. The
// kernel leaves its result in x and co.
//
// What bounds it on the H100: the same mod-P products per digit as the
// three-kernel step (341 at 2^15, 419 at 2^19: the r1 DFTs 2 x L1, the r2
// DFTs 2 x L2, the lane DFTs 2 x 8, the slot products 2 x 128, mf, mi and
// the square), on the integer pipe, plus seven grid barriers per squaring.
// What the design does about it: it removes the
// host from the loop (one launch per chunk of up to 512 squarings instead
// of six grid launches per squaring), and it makes enough tiles to fill
// the card at every n: the row phase goes by slot, so a row's work runs
// in ca = 8 blocks (the 32 rows of n = 2^15 become 256 units), with up
// to four rows per unit where units outnumber blocks, so each matrix word
// serves four rows; K1 and K3a split a column's L1 outputs over up to
// eight tiles while the tiles fit the grid (they read one buffer and
// write the other, so a partial tile never reads what another wrote); and
// each phase's tiles are spread over the SMs (k9_place). One block size
// serves every phase. At 2^18 and 2^19 the slot products alone bound it,
// on the integer pipe. Thread block clusters with a row in distributed
// shared memory, fewer barriers and the inverse lane DFT fused into K2c
// are later changes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "axis_dft.cuh"
#include "fused_c_row.cuh"
#include "k3b_carry.cuh"

namespace cg = cooperative_groups;

#define K9_THREADS 256
#define K9_PER 4     // ct = C = 1024 digits per carry unit
#define K9_MAX_SMS 1024
#define K9_ROWS 4    // most rows per slot unit of the row phase

static_assert(AX_TC * AX_TY == K9_THREADS, "axis tile block size");
static_assert(K3B_THREADS == K9_THREADS, "carry unit block size");

struct ChainArgs {
    u64* x;
    u64* co;
    u64* S;              // (L1, R2, C) scratch the phases move through
    const u64* a;        // (>= count,) multipliers, int64 bit patterns
    int count;
    const u64* k1_mats;
    const u32* wt;
    const u32* cum;
    int kk;
    const u32* er;
    const u32* ec;
    u32 n;
    const u64* g2;
    const u64* mf;
    const u64* lane_f;
    const u64* lane_i;
    const u64* Mf;
    const u64* Mi;
    const u64* mi;
    const u64* tri;
    const u64* k3_mats;
    const u32* widths;
    int rounds;
    int L1, R2, C;
    int sms;             // the card's SM count
};

// Blocks that have taken a place on each SM in the running launch; zero
// between launches (the launch puts it back). K9 is one launch at a time on
// one stream.
__device__ unsigned int k9_sm_blocks[K9_MAX_SMS];

// This block's place in the grid-stride loops, spread over the SMs: the
// scheduler fills an SM with consecutive blocks before it moves on, so a
// phase of few tiles would queue them on a few SMs. When every SM holds the same number of blocks, place
// (slot on its SM) * sms + smid numbers the blocks densely with
// consecutive places on different SMs; otherwise the place is blockIdx.x.
// Ends with a grid barrier.
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

// The arguments of one axis stage over the (O, L, S, C) view, from x to
// out, with the carry-inject and wrap fields every stage may read.
__device__ __forceinline__ AxisArgs axis_args(const ChainArgs& g,
                                              const u64* x, u64* out,
                                              const u64* mats,
                                              const u64* tab, int O, int L,
                                              int S) {
    AxisArgs a;
    a.x = x;
    a.out = out;
    a.mats = mats;
    a.tab = tab;
    a.co = g.co;
    a.wt = g.wt;
    a.cum = g.cum;
    a.kk = g.kk;
    a.ct = g.C;
    a.er = g.er;
    a.ec = g.ec;
    a.n = g.n;
    a.a = 1;
    a.with_a = 0;
    a.O = O;
    a.L = L;
    a.S = S;
    a.C = g.C;
    a.cs = nullptr;
    a.rs = nullptr;
    return a;
}

__global__ void __launch_bounds__(K9_THREADS)
k9_chain_kernel(ChainArgs g) {
    extern __shared__ u64 k9_smem[];
    cg::grid_group grid = cg::this_grid();
    const int tid = threadIdx.x;
    const int L1 = g.L1, R2 = g.R2, C = g.C;
    const int nb = C / AX_TC;        // column slabs of an axis tile
    const int rows = L1 * R2;        // rows = carry units (T = 1)
    const int ca = C / 128;

    // Each stage's arguments built whole: no AxisArgs is a copy of another.
    // The squaring moves between x and the scratch S: K1 x -> S, K2a in
    // place, the slot units S -> x, the inverse lane DFT x -> S, K2c in
    // place, K3a S -> x, K3b in place; so K1 and K3a may split their
    // outputs over several tiles.
    const AxisArgs k1 = axis_args(g, g.x, g.S, g.k1_mats, nullptr, 1, L1, R2);
    const AxisArgs k2a = axis_args(g, g.S, g.S, g.g2, g.mf, L1, R2, 1);
    const AxisArgs k2c = axis_args(g, g.S, g.S, g.tri, g.mi, L1, R2, 1);
    AxisArgs k3a = axis_args(g, g.S, g.x, g.k3_mats, nullptr, 1, L1, R2);

    // K1 / K3a tiles: (r2, slab, output part), the L1 outputs of a column
    // in KS parts of at least AX_TY while the tiles fit the grid
    int KS = 1;
    while (L1 / (2 * KS) >= AX_TY && nb * R2 * 2 * KS <= (int)gridDim.x)
        KS *= 2;
    const int ko = L1 / KS;
    const int t1 = nb * R2 * KS;
    const int t2 = nb * L1;          // K2a / K2c tiles: (r1, slab)
    // rows per slot unit: fewer matrix reads where units outnumber blocks
    int G = 1;
    while (G < K9_ROWS && rows * ca / (2 * G) >= (int)gridDim.x) G *= 2;
    const int tu = rows / G * ca;    // slot units: (row group, slot)
    const int b0 = k9_place(g, grid);
    for (int it = 0; it < g.count; ++it) {
        for (int i = b0; i < t1; i += gridDim.x) {
            const int q = i / KS, kp = i % KS;
            axis_dft_tile<AX_K1>(k1, 0, q / nb, q % nb, kp * ko, kp * ko + ko,
                                 k9_smem, tid);
        }
        grid.sync();
        for (int i = b0; i < t2; i += gridDim.x)
            axis_dft_tile<AX_K2A>(k2a, i / nb, 0, i % nb, 0, R2, k9_smem, tid);
        grid.sync();
        for (int u = b0; u < tu; u += gridDim.x) {
            const int r0 = u / ca * G, j = u % ca;
            if (G == 4)
                row_slot_unit<4>(g.S, g.x, g.lane_f, g.Mf, g.Mi, C, ca, r0,
                                 j, k9_smem, tid);
            else if (G == 2)
                row_slot_unit<2>(g.S, g.x, g.lane_f, g.Mf, g.Mi, C, ca, r0,
                                 j, k9_smem, tid);
            else
                row_slot_unit<1>(g.S, g.x, g.lane_f, g.Mf, g.Mi, C, ca, r0,
                                 j, k9_smem, tid);
        }
        grid.sync();
        for (int r = b0; r < rows; r += gridDim.x)
            row_lane_dft(g.x + (size_t)r * C, g.S + (size_t)r * C, g.lane_i,
                         1, C, ca);
        grid.sync();
        for (int i = b0; i < t2; i += gridDim.x)
            axis_dft_tile<AX_K2C>(k2c, i / nb, 0, i % nb, 0, R2, k9_smem, tid);
        grid.sync();
        k3a.a = g.a[it];
        k3a.with_a = k3a.a != 1ULL;
        for (int i = b0; i < t1; i += gridDim.x) {
            const int q = i / KS, kp = i % KS;
            axis_dft_tile<AX_K3A>(k3a, 0, q / nb, q % nb, kp * ko,
                                  kp * ko + ko, k9_smem, tid);
        }
        grid.sync();
        for (int f = b0; f < rows; f += gridDim.x)
            k3b_unit<K9_PER>(g.x, g.co, g.widths, g.rounds, 0, 0ULL, f,
                             k9_smem, tid);
        grid.sync();
    }
    if (blockIdx.x == 0)
        for (int s = tid; s < K9_MAX_SMS; s += K9_THREADS) k9_sm_blocks[s] = 0;
}

static size_t k9_smem_bytes(int L1, int R2, int C) {
    size_t m = (size_t)(L1 * L1 + L1 * AX_TC);              // K1, K3a
    const size_t m2 = (size_t)(R2 * R2 + R2 * AX_TC);       // K2a, K2c
    const size_t row = 3 * K9_ROWS * 128;                   // K2b
    const size_t carry = (size_t)K9_PER * K3B_THREADS;      // K3b
    if (m2 > m) m = m2;
    if (row > m) m = row;
    if (carry > m) m = carry;
    return m * sizeof(u64);
}

// count squarings in place on x (L1, R2, C) and co (L1 * R2,); a holds at
// least count multipliers. Returns a CUDA error code, or -1 for a shape
// the kernel does not take. It raises (through the wrapper) on a card
// without cooperative launch, or when the launch is refused: there is no
// fallback.
extern "C" int prmers_k9_chain(u64* x, u64* co, u64* S, const u64* a,
                               int count,
                               const u64* k1_mats, const u32* wt,
                               const u32* cum, int kk, const u32* er,
                               const u32* ec, u32 n, const u64* g2,
                               const u64* mf, const u64* lane_f,
                               const u64* lane_i, const u64* Mf,
                               const u64* Mi, const u64* mi, const u64* tri,
                               const u64* k3_mats, const u32* widths,
                               int rounds, int L1, int R2, int C,
                               void* stream) {
    if (C != K9_PER * K3B_THREADS || L1 > 64 || R2 > 8 || kk > C ||
        count < 0)
        return -1;
    if (count == 0) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int coop = 0, sms = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = k9_smem_bytes(L1, R2, C);
    err = cudaFuncSetAttribute(k9_chain_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k9_chain_kernel, K9_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const int nb = C / AX_TC;
    int most = nb * (L1 > R2 ? L1 : R2);
    if (L1 * R2 * (C / 128) > most) most = L1 * R2 * (C / 128);
    int blocks = per_sm * sms;
    if (blocks > most) blocks = most;

    ChainArgs g;
    g.x = x;
    g.co = co;
    g.S = S;
    g.a = a;
    g.count = count;
    g.k1_mats = k1_mats;
    g.wt = wt;
    g.cum = cum;
    g.kk = kk;
    g.er = er;
    g.ec = ec;
    g.n = n;
    g.g2 = g2;
    g.mf = mf;
    g.lane_f = lane_f;
    g.lane_i = lane_i;
    g.Mf = Mf;
    g.Mi = Mi;
    g.mi = mi;
    g.tri = tri;
    g.k3_mats = k3_mats;
    g.widths = widths;
    g.rounds = rounds;
    g.L1 = L1;
    g.R2 = R2;
    g.C = C;
    g.sms = sms;
    void* args[] = {&g};
    err = cudaLaunchCooperativeKernel((const void*)k9_chain_kernel,
                                      dim3(blocks), dim3(K9_THREADS), args,
                                      smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
