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
// What bounds it on the H100: per digit 2 * 64 lane-DFT and 2 * 128 slot
// products at ca = 64 (the integer pipe), and the 8 MiB slot matrices per
// direction, read from L2 once per row. At C = 8192 a block holds one row
// twice plus the 64 x 64 lane matrix: 160 KiB of shared memory, one block
// of 1024 threads per SM.

#include <cuda_runtime.h>

#include "fused_c_row.cuh"

// mode: 0 sqr, 1 mul, 2 fwd (as K2)
extern "C" int prmers_k6_fused_c(const u64* x, u64* out, const u64* u,
                                 int mode, const u64* lane_f,
                                 const u64* lane_i, const u64* Mf,
                                 const u64* Mi, int R, int C, void* stream) {
    const int op = mode == 0 ? ROW_SQR : mode == 1 ? ROW_MUL : ROW_NONE;
    return fused_c_rows(x, out, u, 1, op, mode != 2, lane_f, lane_i, Mf, Mi,
                        R, C, (cudaStream_t)stream);
}

// op: 0 none, 1 sqr, 2 mul
extern "C" int prmers_k6b_fused_c_invh(const u64* x, u64* out, const u64* u,
                                       int op, const u64* lane_i,
                                       const u64* Mi, int R, int C,
                                       void* stream) {
    return fused_c_rows(x, out, u, 0, op, 1, nullptr, lane_i, nullptr, Mi,
                        R, C, (cudaStream_t)stream);
}
