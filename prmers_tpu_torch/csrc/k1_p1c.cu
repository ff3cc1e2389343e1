// K1: carry injection, wrap halve and the r1 DFT of one squaring.
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_p1c_kernel (:512, launched by
// p1_carry_pass :729), with whole-row carries (T = 1) and lane-tiled ones
// (T = C / ct carry units per row, T = 2 at C = 8192). For every carry
// unit of ct digits it
//   1. adds the previous step's boundary carry of the unit before it,
//      spread base-2^width over the unit's first k digits
//      (_inject_rows_math :474);
//   2. halves where er + ec >= n (the single root-of-2 wrap of the
//      IBDWT weight);
//   3. applies the length-L1 DFT down axis 0 with the r2's folded matrix
//      tr_fwd_w (DIF order; the weights' r-part and the T_R twiddle are
//      folded in; here unfolded again, below).
// The Pallas kernel takes carries that an XLA op rolled beforehand; here
// the roll is folded into the indexing (unit u reads carry u-1, unit 0 the
// last unit's: the mod-M_p wrap), so this kernel's carry input is the
// previous K3's carry output as it stands.
//
// The DFT runs as axis_fft.cuh's register-pass shift butterflies on the
// factored matrix: k1_mats[r2] = diag(t_r[:, r2]) DFT_L1 diag(wr[:, r2]),
// so the halved digit is scaled by wr (k1_cs, one word per (r1, r2)),
// transformed by log2(L1) levels of shift butterflies and scaled by t_r
// (k1_rs). It reads neither k1_mats nor any dense matrix.
//
// What bounds it on the H100: the bytes, 16 per digit (the register in
// and out); 2 mod-P products per digit and log2(L1) / 2 shifted
// reductions, in place of the 64 full products of the dense form
// (axis_dft.cuh, which K9's K1 phase keeps). The block layout, the one
// barrier and the in-place rule are axis_fft.cuh's.

#include <cuda_runtime.h>

#include "axis_fft.cuh"

extern "C" int prmers_k1_p1c(const u64* x, u64* out, const u64* co,
                             const u32* wt, const u32* cum, int kk, int ct,
                             const u32* er, const u32* ec, u32 n,
                             const u64* cs, const u64* rs, int L1, int R2,
                             int C, void* stream) {
    if (ct <= 0 || C % ct != 0 || kk > ct) return -1;
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.cs = cs;
    g.rs = rs;
    g.co = co;
    g.wt = wt;
    g.cum = cum;
    g.kk = kk;
    g.ct = ct;
    g.er = er;
    g.ec = ec;
    g.n = n;
    g.O = 1;
    g.L = L1;
    g.S = R2;
    g.C = C;
    return axis_fft_launch<AX_K1>(g, (cudaStream_t)stream);
}
