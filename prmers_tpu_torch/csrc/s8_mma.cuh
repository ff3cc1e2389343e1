// The int8 -> int32 tile product on Hopper's tensor cores, shared by the
// P-shapes dots (probe_shapes.cu) and the matrix form of K4u / K5u
// (k4u_pass.cu).
//
// A warp owns a 64-row by 8*NT-column output tile, held as int32
// accumulators acc[4][NT][4] in mma.sync's fragment order: acc[mt][nt][i]
// is row 16 mt + g + 8 (i >> 1), column 8 nt + 2 t + (i & 1), for lane = 4
// g + t. s8_warp_k32 adds one 32-byte step of the contraction: four
// ldmatrix.x4 for A (64 rows x 32 bytes), NT/2 ldmatrix.x4 (x2 at NT = 1)
// for B, and 4 NT mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. Both
// operands lie in shared memory K-major (a row of A, a column of B: its
// contraction bytes contiguous), as row.col wants; ldmatrix moves 16-byte
// rows, which is the int8 fragment layout, and does not transpose 8-bit
// elements, so a B that arrives N-major (the P-shapes' (K, N) with N
// contiguous) is turned in shared memory first, 4 x 4 bytes at a time
// (s8_transpose4x4, eight byte permutes).
//
// Where a tile sits in shared memory is a layout functor, (row, 16-byte
// unit) -> byte offset, so each kernel picks the one that keeps its
// ldmatrix and its stores free of bank conflicts:
//   S8Pitch  rows of a pitch that is an odd number of 16-byte units (the
//            8 rows one ldmatrix phase reads fall in 8 distinct units);
//   S8SwzA   128-byte rows, unit u of row r at u ^ (r & 7);
//   S8SwzB   128-byte rows, unit u of row n at u ^ (n & 7) ^ ((n >> 3) &
//            3): ldmatrix's 8 consecutive rows land in 8 units, and so do
//            the transpose's stores, whose 8 lanes of one phase write rows
//            4 q + i of 8 consecutive q.
// Operands are staged with 16-byte cp.async (s8_cp_async16, zero-filled
// past the source's end) into a ring of stages the kernels drive.
//
// wgmma (m64nNk32, .s8) is the card's full int8 rate; this first tile
// product stays on mma.sync, whose fragments a warp owns alone, so each
// lane can finish its outputs in registers (K4u's plane combine).
//
// s8_prmt and s8_transpose4x4 are host-callable (GL_FN), so a host
// compiler checks them (tests/test_torch_s8dft.py).
#pragma once

#include "gl64.cuh"

// __byte_perm(a, b, s): byte i of the result is byte (s >> 4i) & 7 of
// the eight bytes (b:a).
GL_FN u32 s8_prmt(u32 a, u32 b, u32 s) {
#if defined(__CUDA_ARCH__)
    return __byte_perm(a, b, s);
#else
    const u64 v = ((u64)b << 32) | a;
    u32 r = 0;
    for (int i = 0; i < 4; ++i)
        r |= (u32)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
    return r;
#endif
}

// rows r[0..3] of four bytes each (byte j is column j) -> columns
// c[0..3] (byte i of c[j] is byte j of r[i]).
GL_FN void s8_transpose4x4(const u32* r, u32* c) {
    const u32 t0 = s8_prmt(r[0], r[1], 0x5140);  // r0b0 r1b0 r0b1 r1b1
    const u32 t1 = s8_prmt(r[0], r[1], 0x7362);  // r0b2 r1b2 r0b3 r1b3
    const u32 t2 = s8_prmt(r[2], r[3], 0x5140);
    const u32 t3 = s8_prmt(r[2], r[3], 0x7362);
    c[0] = s8_prmt(t0, t2, 0x5410);
    c[1] = s8_prmt(t0, t2, 0x7632);
    c[2] = s8_prmt(t1, t3, 0x5410);
    c[3] = s8_prmt(t1, t3, 0x7632);
}

#if defined(__CUDACC__)

struct S8Pitch {
    int pitch;  // bytes, an odd multiple of 16
    __device__ __forceinline__ int operator()(int row, int unit) const {
        return row * pitch + 16 * unit;
    }
};

struct S8SwzA {
    __device__ __forceinline__ int operator()(int row, int unit) const {
        return row * 128 + 16 * (unit ^ (row & 7));
    }
};

struct S8SwzB {
    __device__ __forceinline__ int operator()(int row, int unit) const {
        return row * 128 + 16 * (unit ^ (row & 7) ^ ((row >> 3) & 3));
    }
};

__device__ __forceinline__ u32 s8_smem(const void* p) {
    return (u32)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, the last 16 - bytes of them zero (bytes = 0:
// all zero; src must still be a valid address).
__device__ __forceinline__ void s8_cp_async16(void* dst, const void* src,
                                              int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     s8_smem(dst)),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void s8_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void s8_cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void s8_ldsm_x4(u32* r, const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s8_smem(p)));
}

__device__ __forceinline__ void s8_ldsm_x2(u32* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(s8_smem(p)));
}

__device__ __forceinline__ void s8_mma(int* c, const u32* a, const u32* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A (rows 0..63 at a) x B (columns 0..8 NT - 1 at b) over the 32
// contraction bytes of units au, au + 1 (A) and bu, bu + 1 (B).
template <int NT, class LA, class LB>
__device__ __forceinline__ void s8_warp_k32(int (&acc)[4][NT][4],
                                            const unsigned char* a, LA la,
                                            int au, const unsigned char* b,
                                            LB lb, int bu, int lane) {
    u32 af[4][4], bf[NT][2];
    // x4: lanes 0-15 rows 0-15 of the first 16 bytes, 16-31 of the next
    const int ar = lane & 15, ah = lane >> 4;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
        s8_ldsm_x4(af[mt], a + la(16 * mt + ar, au + ah));
    // x4: lanes 0-7 columns 0-7 bytes 0-15, 8-15 the same columns bytes
    // 16-31, 16-31 columns 8-15 likewise: two n8 tiles
    const int bn = (lane & 7) + ((lane >> 4) << 3), bh = (lane >> 3) & 1;
    if constexpr (NT == 1) {
        s8_ldsm_x2(bf[0], b + lb(lane & 7, bu + bh));
    } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
            u32 r[4];
            s8_ldsm_x4(r, b + lb(16 * np + bn, bu + bh));
            bf[2 * np][0] = r[0];
            bf[2 * np][1] = r[1];
            bf[2 * np + 1][0] = r[2];
            bf[2 * np + 1][1] = r[3];
        }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) s8_mma(acc[mt][nt], af[mt], bf[nt]);
}

template <int NT>
__device__ __forceinline__ void s8_zero(int (&acc)[4][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
}

#endif  // __CUDACC__
