// The Goldilocks side of the int8 matrix form (K4u / K5u, k4u_pass.cu):
// the pack of an input word into its contraction bytes and the combine of
// an output's eight diagonal planes into a lazy word mod P.
//
// The formulation is the reference's scaled-matrix one (prmers_tpu/ops/
// pallas/mxu_dft.py:1-35; the tables: ops/mxu_tables.py): with x = sum_l
// u_l 256^l (bytes u_l) and W8 the balanced int8 limbs of M * 256^l mod P,
//   D_m = sum_(c, l) W8[(r, m), (c, l)] (u_l(x_c) - 128),
//   M x = sum_m (D_m + corr_m) 2^(8m)  (mod P),
// corr adding back the 128 offset, a per-plane offset 2^e (the next power
// of two above contraction * 128 * 255) and its mod-P complement, so every
// plane d_m = D_m + corr_m is non-negative. Bounds: d_m lies in [2^e -
// 8L * 128 * 255, 2^e + 8L * 127 * 255 + 255], so d_m < 2^(e+1): below
// 2^28 at L = 320 (contraction 2560, e = 27; the reference's "< 2^27"
// holds to L = 256 only) and below 2^31 while e <= 30, L <= 4112.
// s8_combine takes any d_m < 2^31.
//
// s8_pack_word is the B operand: u_l - 128 as int8 is u_l XOR 0x80, so a
// word's eight contraction bytes are the word XOR 0x80808080_80808080,
// stored as it is (byte l at contraction c * 8 + l, the device tables'
// column order).
//
// s8_combine: V = sum_m d_m 2^(8m) < 2^88 exactly, as s0 + s1 2^32 with
// s0 = sum_(m<4) d_m 2^(8m), s1 = sum_(m>=4) d_m 2^(8(m-4)) (each < 2^56),
// then V = lo + hi 2^64 (hi < 2^25) and gl_reduce128: lo + hi (2^32 - 1)
// with one wrap folded, lazy out. ops/kernels.s8_combine_model computes
// the same word in torch; both are GL_FN-built by g++ in the tests.
#pragma once

#include "gl64.cuh"

#define S8_XOR 0x8080808080808080ULL

GL_FN u64 s8_pack_word(u64 v) { return v ^ S8_XOR; }

GL_FN u64 s8_combine(const u32* d) {
    const u64 s0 = (u64)d[0] + ((u64)d[1] << 8) + ((u64)d[2] << 16) +
                   ((u64)d[3] << 24);
    const u64 s1 = (u64)d[4] + ((u64)d[5] << 8) + ((u64)d[6] << 16) +
                   ((u64)d[7] << 24);
    const u64 lo = s0 + (s1 << 32);
    const u64 hi = (s1 >> 32) + (lo < s0 ? 1ULL : 0ULL);
    return gl_reduce128(lo, hi);
}
