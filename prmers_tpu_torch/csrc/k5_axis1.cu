// K5: one r2 pass alone, P2 or P6, for the shapes whose r2 passes do not
// fold into the C-transform kernel (R2 * C above the r2fold budget: n =
// 2^26, the split pipeline at n = 2^25, and the radix-5 plans from n =
// 5 * 2^23, where R2 * C = 320 * 2048 and more).
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_pass_kernel in its axis-1
// form (:130, launched by _axis1_pass :391 from _p2_pass / _p6_pass
// :1574-1594):
//   P2  the length-L2 r2 DFT (the generic DIF matrix g2), then x mf;
//   P6  x mi, then the r2 inverse DFT with the r1's matrix tr_inv
//       (t_r_inv folded in as row scales).
// These are exactly the first and last launches of K2 (axis_dft.cuh modes
// AX_K2A and AX_K2C), launched alone over the (R1, L2, C) register. The
// Pallas pass tiles the lane axis to bound VMEM; here a block already
// takes a slab of columns. At a radix-5 L2 = 5 * 2^b (n = 5 * 2^23 and
// up: L2 = 320) the JAX multiplies by natural-order Vandermonde matrices;
// here the pass is r2_split.cuh's 5 x 2^b split (the 5-point DFT, the
// twiddles, b levels of shift butterflies), which reads neither g2 nor
// tri. prmers_r2_split_part launches the split's cut-down bodies (no
// butterflies; the loads and stores alone) for the pass profiler; they
// compute no transform and no engine path takes them.
//
// What bounds it on the H100: at a power-of-two L2, L2 mod-P products per
// digit (64 at 2^25, 128 at 2^26) on the integer pipe; 16 B of device
// traffic per digit. At L2 = 128 the L2 x L2 matrix (128 KiB) and the 128
// x 32 slab take 160 KiB of shared memory, one block of 8 warps per SM;
// each block reads the matrix once from L2 for 32 columns. The split form
// does ~5-6 products per digit and moves 24 bytes (x, out, mf or mi), so
// the bytes bound it.

#include <cuda_runtime.h>

#include "axis_dft.cuh"
#include "r2_split.cuh"

extern "C" int prmers_k5_axis1(const u64* x, u64* out, const u64* mats,
                               const u64* tab, const u64* d5, const u64* tw,
                               const int* ex, const u64* trs, int inverse,
                               int R1, int L2, int C,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (L2 % 5 == 0) {
        const R5Args r = {x, out, tab, d5, tw, ex, trs, R1, L2, C};
        return inverse ? r2_split_launch<AX_K2C>(r, st)
                       : r2_split_launch<AX_K2A>(r, st);
    }
    if (C % AX_TC) return -1;
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.mats = mats;
    g.tab = tab;
    g.O = R1;
    g.L = L2;
    g.S = 1;
    g.C = C;
    return inverse ? axis_dft_launch<AX_K2C>(g, st)
                   : axis_dft_launch<AX_K2A>(g, st);
}

extern "C" int prmers_r2_split_part(const u64* x, u64* out, const u64* tab,
                                    const u64* d5, const u64* tw,
                                    const int* ex, const u64* trs,
                                    int inverse, int part, int R1, int L2,
                                    int C, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const R5Args r = {x, out, tab, d5, tw, ex, trs, R1, L2, C};
    if (part == R5_NO_LEVELS)
        return inverse ? r2_split_launch<AX_K2C, R5_NO_LEVELS>(r, st)
                       : r2_split_launch<AX_K2A, R5_NO_LEVELS>(r, st);
    if (part == R5_MOVE)
        return inverse ? r2_split_launch<AX_K2C, R5_MOVE>(r, st)
                       : r2_split_launch<AX_K2A, R5_MOVE>(r, st);
    return -1;
}
