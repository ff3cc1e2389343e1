// K6 and K6b: the C-transform without the r2 passes, in one kernel or in
// two halves.
//
// K6 replaces prmers_tpu/ops/pallas/kernels.py:_fused_c_kernel with r2cfg
// None (:991, launched by fused_c_pass :1164 with r2fold off): the lane
// DFT, the Mf slot products, the mode (sqr, mul, or a stop for "fwd") and
// the mirror, on a register whose P2 pass (K5) already ran. K6b replaces
// _fused_c_invh_kernel (:1117, launched by fused_c_pass :1209): the head
// op (sqr, mul or none), the Mi slot products and the inverse lane DFT, on
// what K6 "fwd" wrote. The JAX pipeline splits the two halves at ca = 64
// (C = 8192, _fc_split :942) because both table sets do not fit VMEM;
// here each half is the row kernel (fused_c_row.cuh) with the other half
// switched off, so K6 "fwd" + K6b equals K6 in one launch, value for value.
//
// Both halves run the factored row kernel (fused_c_row.cuh): shift
// butterflies for the lane DFT and the 128-point slot DFTs, one product
// per digit by cs_f (forward) or cs_i (inverse), in place of the dense
// ca x ca lane matrix and the 128 x 128 slot matrices Mf / Mi.
//
// What bounds it on the H100: the bytes, 16 per digit (the register in
// and out) and the (ca, 128) scale table; ~1 + log2(C)/2 products' worth
// per digit each way (fourstep.c_fft_products) is far below the integer
// pipe's rate. At C = 8192 a block holds one row once, 64 KiB of shared
// memory, three blocks of 256 threads per SM.
//
// prmers_fused_c_part launches the row kernel's cut-down bodies (no
// 128-point butterflies; the loads and stores alone) for the pass
// profiler at C = 2048 and 8192; they compute no transform and no engine
// path takes them.

#include <cuda_runtime.h>

#include "fused_c_row.cuh"

// mode: 0 sqr, 1 mul, 2 fwd (as K2)
extern "C" int prmers_k6_fused_c(const u64* x, u64* out, const u64* u,
                                 int mode, const u64* cs_f,
                                 const u64* cs_i, int R, int C,
                                 void* stream) {
    const int op = mode == 0 ? ROW_SQR : mode == 1 ? ROW_MUL : ROW_NONE;
    return fused_c_rows(x, out, u, 1, op, mode != 2, cs_f, cs_i, R, C,
                        (cudaStream_t)stream);
}

// op: 0 none, 1 sqr, 2 mul
extern "C" int prmers_k6b_fused_c_invh(const u64* x, u64* out, const u64* u,
                                       int op, const u64* cs_i, int R, int C,
                                       void* stream) {
    return fused_c_rows(x, out, u, 0, op, 1, nullptr, cs_i, R, C,
                        (cudaStream_t)stream);
}

// A cut-down body (part: CF_NO_SLOT_LEVELS or CF_MOVE) of K6 in mode
// "sqr" (the whole row transform and the square) at C = 2048 or 8192.
extern "C" int prmers_fused_c_part(const u64* x, u64* out, int part,
                                   const u64* cs_f, const u64* cs_i, int R,
                                   int C, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (C != 2048 && C != 8192) return -1;
    if (part == CF_NO_SLOT_LEVELS)
        return C == 2048 ? cf_rows<4, CF_NO_SLOT_LEVELS>(
                               x, out, nullptr, 1, ROW_SQR, 1, cs_f, cs_i, R,
                               st)
                         : cf_rows<6, CF_NO_SLOT_LEVELS>(
                               x, out, nullptr, 1, ROW_SQR, 1, cs_f, cs_i, R,
                               st);
    if (part == CF_MOVE)
        return C == 2048 ? cf_rows<4, CF_MOVE>(x, out, nullptr, 1, ROW_SQR, 1,
                                               cs_f, cs_i, R, st)
                         : cf_rows<6, CF_MOVE>(x, out, nullptr, 1, ROW_SQR, 1,
                                               cs_f, cs_i, R, st);
    return -1;
}
