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
// These are exactly the first and last launches of K2, launched alone
// over the (R1, L2, C) register. The Pallas pass tiles the lane axis to
// bound VMEM; here a block already takes a slab of columns. At a
// power-of-two L2 (up to 128 at n = 2^26) the pass is axis_fft.cuh's
// register-pass shift butterflies (modes AX_K2A, AX_K2C): the DIF and x mf;
// x mi, the inverse DIT and x t_r_inv (an (R1, L2) table in place of the
// per-r1 matrices tri). At a radix-5 L2 = 5 * 2^b (n = 5 * 2^23 and up: L2
// = 320) the JAX multiplies by natural-order Vandermonde matrices; here
// the pass is r2_split.cuh's 5 x 2^b split (the 5-point DFT, the
// twiddles, b levels of shift butterflies). Neither reads g2 or tri.
// prmers_r2_split_part and prmers_axis_fft_move launch the two forms'
// cut-down bodies (the split without butterflies or with loads and stores
// alone; the shift form's loads, exchange and stores alone) for the pass
// profiler; they compute no transform and no engine path takes them.
//
// What bounds it on the H100: the bytes, 24 per digit (x in, x out, mf or
// mi). The shift form does 1 (P2) or 2 (P6) mod-P products per digit and
// log2(L2) / 2 shifted reductions; the split form ~5-6 products per digit.

#include <cuda_runtime.h>

#include "axis_fft.cuh"
#include "r2_split.cuh"

extern "C" int prmers_k5_axis1(const u64* x, u64* out, const u64* tab,
                               const u64* d5, const u64* tw, const int* ex,
                               const u64* trs, int inverse, int R1, int L2,
                               int C, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (L2 % 5 == 0) {
        const R5Args r = {x, out, tab, d5, tw, ex, trs, R1, L2, C};
        return inverse ? r2_split_launch<AX_K2C>(r, st)
                       : r2_split_launch<AX_K2A>(r, st);
    }
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.tab = tab;
    g.rs = trs;
    g.O = R1;
    g.L = L2;
    g.S = 1;
    g.C = C;
    return inverse ? axis_fft_launch<AX_K2C>(g, st)
                   : axis_fft_launch<AX_K2A>(g, st);
}

// The move-only body of axis_fft.cuh (AXF_MOVE) in one mode (AX_K1,
// AX_K2A, AX_K2C or AX_K3A) over the (O, L, S, C) view at L = 64 or 128
// (64 for the r1 modes): the loads of x and of the mode's tables (cs
// before, tab or rs after), the shared-memory exchange and the stores, an
// add for each product. K4 forward's (AX_K4F) would be AX_K1's: both read
// k1_cs and k1_rs, and neither reads the carries.
extern "C" int prmers_axis_fft_move(const u64* x, u64* out, const u64* tab,
                                    const u64* cs, const u64* rs, int mode,
                                    int O, int L, int S, int C,
                                    void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.tab = tab;
    g.cs = cs;
    g.rs = rs;
    g.O = O;
    g.L = L;
    g.S = S;
    g.C = C;
    if (mode == AX_K1) return axis_fft_launch<AX_K1, AXF_MOVE>(g, st);
    if (mode == AX_K2A) return axis_fft_launch<AX_K2A, AXF_MOVE>(g, st);
    if (mode == AX_K2C) return axis_fft_launch<AX_K2C, AXF_MOVE>(g, st);
    if (mode == AX_K3A) return axis_fft_launch<AX_K3A, AXF_MOVE>(g, st);
    return -1;
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
