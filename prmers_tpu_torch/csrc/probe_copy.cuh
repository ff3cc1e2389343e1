// The copy cases of the shape probes (csrc/probe_shapes.cu): each case's
// map from an output's 16-byte unit to the input units it is made of, with
// the case's shape folded into compile-time constants and shifts.
//
// A unit is 16 bytes (four u32 words, or 16 int8 bytes) and every case's
// index map keeps 16 bytes contiguous: rows of 128 words or bytes are runs
// of 32 or 8 units. copy_unit<CS>(in, q) returns output unit q of case CS
// from the input's units; COPY_UNITS<CS> is the number of output units
// (below 2^21 in every case, so the index math is 32-bit). The functions
// are host-callable, so a host compiler checks them against the plain
// torch versions (tests/test_torch_probes.py).
#pragma once

#include "gl64.cuh"

struct alignas(16) W4 {
    u32 x, y, z, w;
};

// output units of each case (4 words or 16 bytes each)
template <int CS>
constexpr int COPY_UNITS =
    CS == 'a' ? 64 * 64 * 128 / 4 :      // (64,8,8,128) -> (64,64,128)
    CS == 'c' ? 512 * 64 * 128 / 16 :    // 8 x (64,64,128) int8 on axis 0
    CS == 'd' ? 576 * 64 * 128 / 4 :     // (576,64,128) -> (9,64,64,128)
    CS == 'f' ? 64 * 64 * 128 / 16 :     // u32 -> int8, its low byte
    CS == 'g' ? 512 * 1024 / 16 :        // 8 x (512,128) int8 on the lanes
    CS == 'h' ? 64 * 1024 / 4 :          // (576,1024)[64:128]
    CS == 'i' ? 576 * 128 / 4 :          // (576,1024)[:, 128:256]
    CS == 'j' ? 64 * 128 / 4 :           // sum_j<8 x[:, j, :], (64,64,128)
    CS == 'k' ? 64 * 8 * 128 / 4 :       // x + 1 on (64,8,128) u32
    CS == 'l' ? 64 * 128 / 4 :           // x[:, 0:1, :] of (64,64,128)
    CS == 'm' ? 512 * 1024 / 16 : 0;     // (64,8,128) int8 as (64,1024), 8x

GL_FN u32 copy_low_bytes(W4 v) {
    return (v.x & 0xFFu) | (v.y & 0xFFu) << 8 | (v.z & 0xFFu) << 16 |
           (v.w & 0xFFu) << 24;
}

GL_FN W4 copy_add(W4 a, W4 b) {
    return W4{a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
}

// Output unit q of case CS, 0 <= q < COPY_UNITS<CS>.
template <int CS>
GL_FN W4 copy_unit(const W4* in, int q) {
    if constexpr (CS == 'c') {
        return in[q & (64 * 64 * 128 / 16 - 1)];     // the input again
    } else if constexpr (CS == 'f') {
        // 16 words (four units) to their 16 low bytes, in order
        return W4{copy_low_bytes(in[4 * q]), copy_low_bytes(in[4 * q + 1]),
                  copy_low_bytes(in[4 * q + 2]),
                  copy_low_bytes(in[4 * q + 3])};
    } else if constexpr (CS == 'g') {
        return in[(q >> 6) * 8 + (q & 7)];           // row q/64, 8 units
    } else if constexpr (CS == 'h') {
        return in[q + 64 * 1024 / 4];                // from row 64
    } else if constexpr (CS == 'i') {
        return in[(q >> 5) * 256 + 32 + (q & 31)];   // 32 of 256 a row
    } else if constexpr (CS == 'j') {
        // rows (r, 0 ... 7) of (64, 64) rows of 32 units, summed
        const W4* p = in + (q >> 5) * 64 * 32 + (q & 31);
        W4 s = p[0];
#pragma unroll
        for (int j = 1; j < 8; ++j) s = copy_add(s, p[32 * j]);
        return s;
    } else if constexpr (CS == 'k') {
        return copy_add(in[q], W4{1u, 1u, 1u, 1u});
    } else if constexpr (CS == 'l') {
        return in[(q >> 5) * 64 * 32 + (q & 31)];    // row (r, 0)
    } else if constexpr (CS == 'm') {
        return in[q & (64 * 1024 / 16 - 1)];         // the input again
    } else {
        static_assert(CS == 'a' || CS == 'd', "not a copy case");
        return in[q];                                // a, d: as it lies
    }
}
