// K2: the fused C-transform of one step, with the r2 passes folded in.
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_fused_c_kernel in its r2fold
// form (:991, launched by fused_c_pass :1164), modes "sqr", "mul", "fwd".
// For each r1 the Pallas kernel holds all of (R2, C) in VMEM and runs
//   1. the r2 DFT with the generic L2 matrix, then x mf;
//   2. the lane-tile DFT over ca = c >> 7 (fourstep.dft_lanes :447);
//   3. per ca slot j one 128x128 right-side product with Mf[j]
//      (out[b, k] = sum_l x[b, l] * M[l, k]);
//   4. the square, or x u, or a stop for "fwd" (the stored multiplicand);
//   5. the mirror: Mi[j], the inverse lane DFT, x mi, the r2 inverse with
//      the r1's tr_inv matrix.
// One r1 slab at n = 2^23 is 64 x 2048 x 8 B = 1 MiB, more than a block's
// 227 KB of shared memory, so here the work is three launches, split at
// the r2 / C seams:
//   K2a  steps 1     the r2 DFT as register-pass shift butterflies
//                    (axis_fft.cuh, the DIF order of g2), x mf after;
//   K2b  steps 2-5a  the row kernel (fused_c_row.cuh) over the R rows:
//                    lane DFT, slot products, the mode, the mirrored slot
//                    products and inverse lane DFT, factored: shift
//                    butterflies and one product per digit by cs_f, cs_i
//                    each way in place of the dense lane_f / Mf matrices;
//   K2c  step 5b     x mi, then the inverse r2 DFT as shift butterflies
//                    (axis_fft.cuh) and x t_r_inv[r1] (tr_inv factored).
// "fwd" stops after K2b's forward half, in the JAX spectral layout (same
// matrices, same DIF order), so a multiplicand agrees mod P with the JAX
// one and a checkpoint carries it across. All three run in place on out.
//
// At the radix-5 plans (n = 5 * 2^k, L2 = 5 * 2^b up to 320), where the
// JAX multiplies by natural-order r2 DFT matrices (mxu_dft.py:60-67), K2a
// and K2c are r2_split.cuh's 5 x 2^b split; K2b does not change. No
// launch of K2 reads g2 or tri.
//
// What bounds it on the H100: the bytes, 16 per digit through each of
// the three launches and mf, mi once (K2a and K2c read mf or mi beside
// the register). The products per digit: at a power-of-two L2 one (K2a)
// and two (K2c) beside log2(L2) / 2 shifted reductions each (axis_fft.cuh;
// the dense L2-point matrices g2 and tri are read by the plain versions
// and K9 only), at L2 = 5 * 2^b ~4-6 each by the split; the row kernel ~1
// + log2(C)/2 each way (fourstep.c_fft_products) and the op.

#include <cuda_runtime.h>

#include "axis_fft.cuh"
#include "fused_c_row.cuh"
#include "r2_split.cuh"

enum { K2_SQR = 0, K2_MUL = 1, K2_FWD = 2 };

extern "C" int prmers_k2_fused_c(const u64* x, u64* out, const u64* u,
                                 int mode, const u64* mf,
                                 const u64* cs_f, const u64* cs_i,
                                 const u64* mi, const u64* d5f, const u64* d5i,
                                 const u64* twf, const u64* twi,
                                 const int* ex, const u64* trs,
                                 int R1, int L2, int C,
                                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const bool r5 = L2 % 5 == 0;
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.tab = mf;
    g.rs = trs;
    g.O = R1;
    g.L = L2;
    g.S = 1;
    g.C = C;
    R5Args r = {x, out, mf, d5f, twf, ex, trs, R1, L2, C};
    int err = r5 ? r2_split_launch<AX_K2A>(r, st)
                 : axis_fft_launch<AX_K2A>(g, st);
    if (err) return err;

    const int op = mode == K2_SQR ? ROW_SQR : mode == K2_MUL ? ROW_MUL
                                                            : ROW_NONE;
    err = fused_c_rows(out, out, u, 1, op, mode != K2_FWD, cs_f, cs_i,
                       R1 * L2, C, st);
    if (err || mode == K2_FWD) return err;

    if (r5) {
        r = R5Args{out, out, mi, d5i, twi, ex, trs, R1, L2, C};
        return r2_split_launch<AX_K2C>(r, st);
    }
    g.x = out;
    g.tab = mi;
    return axis_fft_launch<AX_K2C>(g, st);
}
