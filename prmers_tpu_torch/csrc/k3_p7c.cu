// K3: the r1 inverse DFT and the carry of one step.
//
// Replaces prmers_tpu/ops/pallas/kernels.py:_p7c_kernel (:612, launched by
// p7_carry_pass :799), with whole-row carries (T = 1) and lane-tiled ones
// (carry units of ct = C / T digits; T = 2 at C = 8192). The steps are
//   1. the length-L1 inverse DFT down axis 0 with the r2's folded matrix
//      iw_inv (inverse weights' r-part and 1/n folded in; here unfolded
//      again, below);
//   2. double where er + ec >= n, then canon;
//   3. optionally x a, then canon (with_a);
//   4. optionally + (M_p - 2) for the LL step (sub2: every digit + its
//      mask, minus s2 at global digit 0 only, :655-667 and the 2-D grid
//      check :862);
//   5. the digit/carry split by width, a fixed number of lane-ripple
//      rounds (_carry_rounds :681) and the residual added unsplit
//      (_carry_phase_math :562-609), each inside its carry unit;
//   6. the unit's out-carry, left for the next step's K1.
// The DFT follows columns (an r1 slab of each r2) while the carry follows
// a unit of ct consecutive digits, so this is two launches with the seam
// between steps 3 and 4: K3a = steps 1-3 (in place), K3b = steps 4-6, one
// block per carry unit (units are contiguous: unit u = row * T + t holds
// digits [u * ct, (u + 1) * ct)).
//
// K3a runs as axis_fft.cuh's register-pass shift butterflies (mode
// AX_K3A) on the factored matrix: k3_mats[r2] = diag(k3_rs[:, r2])
// DFT_L1^-1, so the inverse DIT (DIF order in, natural out) is log2(L1)
// levels of shift butterflies, then x k3_rs, the double, canon and x a.
// It reads neither k3_mats nor any dense matrix, and its canonical output
// is the dense form's bit for bit (K9's K3a phase keeps that form,
// axis_dft.cuh).
//
// What bounds it on the H100: the bytes. K3a moves 16 per digit (the
// register in and out) against 1 mod-P product (2 with x a) and log2(L1)
// / 2 shifted reductions per digit, in place of the dense form's 64
// products; K3b is a memory pass (8 B in, 8 B out and 4 B of widths per
// digit) with a few shared-memory rounds. The design keeps a row's
// carries in shared memory between rounds, so each round is one
// __syncthreads and no device traffic.

#include <cuda_runtime.h>

#include "axis_fft.cuh"
#include "k3b_carry.cuh"

// One block per carry unit of PER * 256 digits.
template <int PER>
__global__ void __launch_bounds__(K3B_THREADS)
k3b_kernel(u64* x, u64* co, const u32* widths, int rounds, int sub2,
           u64 s2) {
    __shared__ u64 k3_cs[PER * K3B_THREADS];
    k3b_unit<PER>(x, co, widths, rounds, sub2, s2, blockIdx.x, k3_cs,
                  threadIdx.x);
}

template <int PER>
static int k3b_launch(u64* x, u64* co, const u32* widths, int units,
                      int rounds, int sub2, u64 s2, cudaStream_t st) {
    k3b_kernel<PER><<<units, K3B_THREADS, 0, st>>>(x, co, widths, rounds,
                                                  sub2, s2);
    return (int)cudaGetLastError();
}

extern "C" int prmers_k3_p7c(const u64* x, u64* out, u64* co,
                             const u64* rs, const u32* er, const u32* ec,
                             u32 n, const u32* widths, int rounds, u64 a,
                             int with_a, int sub2, u64 s2, int L1, int R2,
                             int C, int ct, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    // K3b holds a unit in one block: ct = 256 ... 4096 digits
    if (ct < 256 || ct > 4096 || (ct & (ct - 1)) || C % ct) return -1;
    AxisArgs g = {};
    g.x = x;
    g.out = out;
    g.rs = rs;
    g.er = er;
    g.ec = ec;
    g.n = n;
    g.a = a;
    g.with_a = with_a;
    g.O = 1;
    g.L = L1;
    g.S = R2;
    g.C = C;
    int err = axis_fft_launch<AX_K3A>(g, st);
    if (err) return err;
    const int units = L1 * R2 * (C / ct);
    switch (ct) {
    case 256:
        return k3b_launch<1>(out, co, widths, units, rounds, sub2, s2, st);
    case 512:
        return k3b_launch<2>(out, co, widths, units, rounds, sub2, s2, st);
    case 1024:
        return k3b_launch<4>(out, co, widths, units, rounds, sub2, s2, st);
    case 2048:
        return k3b_launch<8>(out, co, widths, units, rounds, sub2, s2, st);
    default:
        return k3b_launch<16>(out, co, widths, units, rounds, sub2, s2, st);
    }
}
