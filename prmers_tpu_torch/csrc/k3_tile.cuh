// K3's row carry by tiles of K3_TW digits, the carry half of its one launch
// (k3_p7c.cu): the digit/carry split by width, `rounds` shift-by-one
// rounds, then the residual added unsplit (prmers_tpu/ops/pallas/
// kernels.py:_carry_phase_math :562-609, k3b_carry.cuh's unit), with the
// carries that cross a tile's edge handed on as words.
//
// Why a tile's edge words need nothing from the tile before it: the carry
// that leaves digit l in round r depends only on the digits l - r ... l
// (it moves one digit a round; K7's halo argument, k7_block_carry.cu). So
// with rounds < K3_TW, the carries that leave a tile's last digit in
// rounds 0 ... rounds are the same whatever enters its first digit: a tile
// computes them with zeros in (its edge words), publishes them, and only
// then needs its predecessor's edge words, which enter its first digit in
// the same rounds. A unit's first tile takes zeros; the sum of its last
// tile's edge words is the unit's out-carry, what k3b_unit's acc sums.
//
// The steps are GL_FN, so a host compiler builds k3_row_carry
// (tests/test_torch_k3one.py holds it, tile by tile, to the plain carry);
// the kernel runs the same steps with a warp's 32 lanes as the digits.
#pragma once

#include "gl64.cuh"

#define K3_TW 32        // digits of a tile row: one warp's lanes

// y split by the width w (1 <= w < 32): digit d < 2^w, carry c = y >> w.
GL_FN void k3_split(u64 y, u32 w, u32& d, u64& c) {
    d = (u32)y & ((1u << w) - 1u);
    c = y >> w;
}

// One shift round of a digit: sh, the carry of the digit before, added
// and split again.
GL_FN void k3_round(u32& d, u64& c, u64 sh, u32 w) {
    k3_split((u64)d + sh, w, d, c);
}

// The last shift: the residual (< 2^(wmin-1)) goes in unsplit.
GL_FN u32 k3_last(u32 d, u64 sh) { return d + (u32)sh; }

// What sub2 (the LL step's + (M_p - s2)) adds to a digit of width w: its
// mask, less s2 at the register's digit 0.
GL_FN u64 k3_sub2_add(u32 w, bool digit0, u64 s2) {
    const u64 mk = (1ULL << w) - 1ULL;
    return digit0 ? mk - s2 : mk;
}

// The carry of one tile row in place: tw <= K3_TW values (canonical, sub2's
// add included) at x[0], x[xs], ..., their widths at w[0], w[ws], ...;
// cin[r] (r = 0 ... rounds) the carry that enters digit 0 in round r, or
// null for zeros (a unit's first tile); cout (or null) takes the carry
// that leaves digit tw - 1 in round r. Returns the sum of those, the
// unit's out-carry when the row is its last tile's. The digits out are
// below 2^32.
GL_FN u64 k3_row_carry(u64* x, long xs, const u32* w, long ws, int tw,
                       int rounds, const u64* cin, u64* cout) {
    u32 d[K3_TW];
    u64 c[K3_TW];
    for (int l = 0; l < tw; ++l) k3_split(x[l * xs], w[l * ws], d[l], c[l]);
    u64 acc = 0;
    for (int r = 0; r <= rounds; ++r) {
        const u64 out = c[tw - 1];
        if (cout != nullptr) cout[r] = out;
        acc += out;
        // high to low, so each digit reads its neighbour's old carry
        for (int l = tw - 1; l >= 0; --l) {
            const u64 sh = l > 0 ? c[l - 1] : cin != nullptr ? cin[r] : 0ULL;
            if (r < rounds)
                k3_round(d[l], c[l], sh, w[l * ws]);
            else
                d[l] = k3_last(d[l], sh);
        }
    }
    for (int l = 0; l < tw; ++l) x[l * xs] = d[l];
    return acc;
}
