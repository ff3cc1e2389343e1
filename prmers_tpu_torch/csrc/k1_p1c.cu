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
//      folded in).
// The Pallas kernel takes carries that an XLA op rolled beforehand; here
// the roll is folded into the indexing (unit u reads carry u-1, unit 0 the
// last unit's: the mod-M_p wrap), so this kernel's carry input is the
// previous K3's carry output as it stands.
//
// What bounds it on the H100: 64 mod-P products per digit (a 64x64->128
// multiply is several IMADs on the integer pipe), against 16 bytes of
// device traffic per digit. The integer pipe is the limit, not memory.
// The design keeps the 32 KB matrix and a 64 x 32 slab in shared memory
// so each global word is read and written once, coalesced, and sums each
// output's 64 full 128-bit products in a 192-bit accumulator with one
// reduction at the end. The products themselves are the direct matrix
// form, which the tensor-core limb-plane form (int8 wgmma) or butterflies
// would cut in a later change.

#include <cuda_runtime.h>

#include "axis_dft.cuh"

extern "C" int prmers_k1_p1c(const u64* x, u64* out, const u64* co,
                             const u32* wt, const u32* cum, int kk, int ct,
                             const u32* er, const u32* ec, u32 n,
                             const u64* mats, int L1, int R2, int C,
                             void* stream) {
    if (ct <= 0 || C % ct != 0 || kk > ct) return -1;
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.mats = mats;
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
    return axis_dft_launch<AX_K1>(g, (cudaStream_t)stream);
}
