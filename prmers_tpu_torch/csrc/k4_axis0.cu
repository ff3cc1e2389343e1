// K4: the r1 passes of the block-carry pipeline and of the canonical-digit
// hybrid, forward (P1) and inverse (P7), each without a carry phase.
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_pass_kernel in its axis-0
// form (:130, launched by _axis0_pass :268, pallas_call :365) with the
// weight-folded MXU tables, the form _p1_pass and _p7_pass (:1619-1639)
// take on every default path:
//   forward  1. when the block carries are given (the block-carry
//               pipeline; the hybrid gives none): block j-1's carry
//               (block 0: the last block's, the mod-M_p wrap), spread
//               base-2^width over the first kk digits of r1 block j. The
//               JAX does this as an XLA strip before the kernel
//               (inject_block_carries :1505); folding it in here moves
//               that stage boundary, as K1 folds in its roll;
//            2. halve where er + ec >= n;
//            3. the length-L1 DFT down axis 0 with the r2's folded matrix
//               tr_fwd_w;
//   inverse  the length-L1 inverse DFT with the r2's folded iw_inv, double
//            where er + ec >= n, canon: K3's first launch without x a.
// The JAX tiles the lanes with a 2-D grid when L * S * C reaches 2^22
// (C = 8192); a block here already holds a slab of AX_TC columns, so the
// one grid serves every C.
//
// Both run as axis_fft.cuh's register-pass shift butterflies on the
// factored matrices: forward mode AX_K4F, K1's body (x k1_cs, the DIF, x
// k1_rs; k1_mats[r2] = diag(k1_rs[:, r2]) DFT_L1 diag(k1_cs[:, r2])) with
// the block-carry inject as its prologue; inverse mode AX_K3A with no x a
// (x k3_rs after the inverse DIT). Neither reads k1_mats or k3_mats.
//
// What bounds it on the H100: the bytes, 16 per digit (the register in
// and out), against 2 (forward) or 1 (inverse) mod-P products and
// log2(L1) / 2 shifted reductions per digit, as K1 and K3a.

#include <cuda_runtime.h>

#include "axis_fft.cuh"

extern "C" int prmers_k4_axis0(const u64* x, u64* out, int inverse,
                               const u64* co, const u32* wt, const u32* cum,
                               int kk, const u32* er, const u32* ec, u32 n,
                               const u64* cs, const u64* rs, int L1, int R2,
                               int C, void* stream) {
    if (kk <= 0 || kk > C) return -1;
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.cs = cs;
    g.rs = rs;
    g.co = co;
    g.wt = wt;
    g.cum = cum;
    g.kk = kk;
    g.er = er;
    g.ec = ec;
    g.n = n;
    g.O = 1;
    g.L = L1;
    g.S = R2;
    g.C = C;
    cudaStream_t st = (cudaStream_t)stream;
    return inverse ? axis_fft_launch<AX_K3A>(g, st)
                   : axis_fft_launch<AX_K4F>(g, st);
}
