// K3: the r1 inverse DFT and the row carry of one step, in one launch.
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
// Units are contiguous: unit u = row * T + t holds digits [u * ct, (u + 1)
// * ct) of the (L1, R2, C) register, row = k * R2 + s.
//
// A block is a tile: one r2 slab s, 32 consecutive columns, all L1 rows.
// Steps 1-3 are axis_fft.cuh's inverse tile (mode AX_K3A, axf_inv_values
// and axf_post: log2(L1) levels of shift butterflies on the factored
// matrix k3_mats[s] = diag(k3_rs[:, s]) DFT_L1^-1, x k3_rs, the double,
// canon, x a). After them the thread (tx, ty) holds rows k = ty + 8t of
// column cb * 32 + tx, so row k's 32 digits of the tile are the lanes of
// warp ty, and a carry round (the carry of the digit before) is one
// __shfl_up_sync. Steps 4-6 run there (k3_tile.cuh): the carries that
// leave lane 31 in rounds 0 ... rounds depend on the tile's own digits
// alone (rounds < 32), so the tile
//   a. runs the rounds with zeros entering lane 0 (lane 31 leaves each
//      round's carry in the warp's own rows of the exchange buffer: its
//      edge words, rounds + 1 a row);
//   b. publishes them in the scratch, then raises its flag (skipped by a
//      unit's last tile, which writes the unit's out-carries, their sums);
//   c. waits for the flag of the tile before it in its unit (a unit's
//      first tile waits for none: a's digits are its own), and runs the
//      rounds again from the split with that tile's words entering lane 0,
//      round by round, on the rounds + 1 lanes of each row that they can
//      change (packed into a warp's lanes, k3_rounds_in);
//   d. stores its digits over what it read.
// Nothing goes through the register between the halves, and each block
// writes only what it read, so the launch runs in place (out == x), as
// every caller runs it. The edge words pass through the scratch, never
// through the register: a block reading digits another block writes would
// race there (K7's halo form).
//
// Why the order is safe. A block takes its tile from a ticket (an atomic
// counter in the scratch), not from blockIdx, so tiles start in ticket
// order: the tile a block waits for took its ticket earlier, so it is
// resident, and it publishes (step b) before it waits for anything. No
// chain of waits forms and no wait can deadlock, whatever the scheduler
// runs. The flags carry an epoch: the launch raises them to epoch + 1,
// the block that takes the last ticket resets the ticket and moves the
// epoch on for the next launch (each block read the epoch before taking
// its ticket), so nothing outside the launch resets them: no memset, and
// a captured CUDA graph replays as is. A flag is raised by a release
// store after a block barrier that follows the edge stores, and read by
// an acquire load, then a barrier, then the words through L2 (__ldcg). A
// wait past K3_WAIT_NS traps, so a broken order fails the launch and
// cannot hang the card. One launch at a time may use a scratch.
//
// What bounds it. Device bytes, about 20 per digit: 8 in, 8 out, 4 of
// widths (two launches moved 36: the register twice more between them);
// the scratch adds 2 x 8 (rounds + 1) / 32 per digit, 2 at rounds = 3,
// most of it in L2. But the inverse tile issues more instructions than
// those bytes take (AX_TC x AX_TY threads, L1 / 8 values each, every
// butterfly on 64-bit words in 32-bit instructions), and the carry adds 2
// (rounds + 1) shuffle rounds on each of a thread's rows: on the H100 it
// is the instruction issue that bounds it (PERF.md; `python -m
// prmers_tpu_torch.tools.sass --kernels` counts them). So the design keeps
// issue slots busy: the rounds unrolled at the plans' counts (2 to 4), a
// digit in 32 bits, the edge words through shared memory (one lane's
// store) rather than more shuffles, pass c on the lanes it changes only,
// and 64 registers a thread, four blocks to an SM. It takes L1 = 32 and 64 (every plan's),
// ct = 256 ... 4096 and rounds + 1 <= 32, and refuses any other shape or
// a scratch too small (K3_HDR + tiles (1 + L1 (rounds + 1)) words,
// ops/kernels.k3_scratch_words).

#include <cuda_runtime.h>

#include "axis_fft.cuh"
#include "k3_tile.cuh"

#define K3_HDR 4                  // scratch words before the flags: the
                                  // ticket, the epoch, two spare
#define K3_WAIT_NS 10000000000ULL  // 10 s
#define K3_LANES 0xffffffffu

namespace {

struct K3Args {
    AxisArgs g;                   // steps 1-3 (AX_K3A)
    u64* co;                      // (L1, R2, T) unit out-carries
    const u32* widths;            // (L1, R2, C)
    int rounds;
    int sub2;
    u64 s2;
    int ct;
    u64* scratch;
};

__device__ __forceinline__ u64 k3_ld_acquire(const u64* p) {
    u64 v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void k3_st_release(u64* p, u64 v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 k3_now() {
    u64 t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Pass a's rounds on the T rows a thread holds: row t's 32 digits are the
// lanes of the warp, d < 2^w its digits, c its carries, e its slot of
// K3_TW words in shared memory (row t's at e + 8 t AX_TC). Lane 0 takes
// zeros; lane 31 leaves the carry of round r in the slot's word r (the
// edge words). RND > 0 fixes the rounds (the loops unroll), RND = 0 reads
// them from rounds.
template <int T, int RND>
__device__ __forceinline__ void k3_rounds_out(u32* d, u64* c, const u32* w,
                                              int rounds, int tx, u64* e) {
    auto step = [&](int r, int last) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
            if (tx == K3_TW - 1) e[8 * t * AX_TC + r] = c[t];
            u64 sh = __shfl_up_sync(K3_LANES, c[t], 1);
            if (tx == 0) sh = 0ULL;
            if (r < last)
                k3_round(d[t], c[t], sh, w[t]);
            else
                d[t] = k3_last(d[t], sh);
        }
    };
    if constexpr (RND > 0) {
#pragma unroll
        for (int r = 0; r <= RND; ++r) step(r, RND);
    } else {
        for (int r = 0; r <= rounds; ++r) step(r, rounds);
    }
}

// Pass c's rounds, on the lanes they change: the tile before's carry of
// round r enters lane 0 in round r and reaches lane l in round r + l, so
// between passes a and c only lanes 0 ... rounds of a row change. The
// warp packs those R = rounds + 1 digits of P = 32 / R rows into a pass
// of its lanes (lane j: row q P + j / R, digit j % R), runs the rounds
// there from the split of y, the row's first digit taking the slot's word
// r in round r, and hands each digit back to its lane in d; the other
// lanes keep a's digits.
template <int T, int RND>
__device__ __forceinline__ void k3_rounds_in(u32* d, const u64* y,
                                             const u32* w, int rounds_rt,
                                             int tx, const u64* e) {
    const int rounds = RND > 0 ? RND : rounds_rt;
    const int R = rounds + 1;
    const int P = K3_TW / R;             // rows a pass
    const int Q = (T + P - 1) / P;       // passes
    const int l = tx % R;                // the lane's digit in its row
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int t = q * P + tx / R;    // the lane's row
        const bool on = tx / R < P && t < T;
        u64 yv = 0ULL;
        u32 wv = 1u;
#pragma unroll
        for (int tt = 0; tt < T; ++tt) {
            if (tt / P != q) continue;   // uniform: the rows of pass q
            const u64 a = __shfl_sync(K3_LANES, y[tt], l);
            const u32 b = __shfl_sync(K3_LANES, w[tt], l);
            if (tt == t) {
                yv = a;
                wv = b;
            }
        }
        u32 dv;
        u64 cv;
        k3_split(yv, wv, dv, cv);
#pragma unroll
        for (int r = 0; r <= rounds; ++r) {
            u64 sh = __shfl_sync(K3_LANES, cv, (tx + K3_TW - 1) % K3_TW);
            if (l == 0) sh = on ? e[8 * t * AX_TC + r] : 0ULL;
            if (r < rounds)
                k3_round(dv, cv, sh, wv);
            else
                dv = k3_last(dv, sh);
        }
#pragma unroll
        for (int tt = 0; tt < T; ++tt) {
            if (tt / P != q) continue;
            const u32 v = __shfl_sync(K3_LANES, dv,
                                      (tt - q * P) * R + (tx < R ? tx : 0));
            if (tx < R) d[tt] = v;
        }
    }
}

template <int LL, int RND>
__global__ void __launch_bounds__(AX_TC * AX_TY, 4) k3_kernel(K3Args k) {
    constexpr int L = 1 << LL;
    constexpr int T = L / 8;             // rows a thread holds
    __shared__ u64 xs[L * AX_TC];
    __shared__ u64 ticket[2];
    const AxisArgs& g = k.g;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const bool lead = tx == 0 && ty == 0;
    const int NB = g.C / AX_TC;          // tiles a row of one slab
    const int ntiles = g.S * NB;
    u64* const flag = k.scratch + K3_HDR;  // (tiles,)
    u64* const edge = flag + ntiles;       // (tiles, L, R)
    if (lead) {
        const u64 ep = *(volatile u64*)(k.scratch + 1);
        __threadfence();
        const u64 tk = atomicAdd((unsigned long long*)k.scratch, 1ULL);
        if (tk == (u64)ntiles - 1) {     // the last ticket: ready the next
            *(volatile u64*)k.scratch = 0ULL;
            *(volatile u64*)(k.scratch + 1) = ep + 1;
        }
        ticket[0] = tk;
        ticket[1] = ep + 1;
    }
    __syncthreads();
    const int tile = (int)ticket[0];
    const u64 mark = ticket[1];
    const int s = tile / NB, cb = tile % NB;
    const int c = cb * AX_TC + tx;
    const int tpu = k.ct / AX_TC;        // tiles a carry unit
    const int pos = cb % tpu;
    const int R = k.rounds + 1;          // edge words a row
    const size_t rs = (size_t)g.S * g.C;  // one step of k
    const size_t base = (size_t)s * g.C + c;
    u32 w[T];
#pragma unroll
    for (int t = 0; t < T; ++t) w[t] = k.widths[base + (ty + 8 * t) * rs];
    // steps 1-4
    u64 y[T];
    axf_inv_values<AX_K3A, LL, AXF_FULL>(g, 0, s, cb, tx, ty, xs, y);
#pragma unroll
    for (int t = 0; t < T; ++t) {
        const int row = ty + 8 * t;
        y[t] = axf_post<AX_K3A, AXF_FULL>(g, y[t], 0, row, s, c,
                                          base + row * rs);
        if (k.sub2)
            y[t] += k3_sub2_add(w[t], row == 0 && s == 0 && c == 0, k.s2);
    }
    // a: the rounds with zeros in, the edge words out into the warp's own
    // rows of xs (read by this warp alone since the exchange)
    u64* const e = xs + ty * AX_TC;
    u32 d[T];
    u64 cc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) k3_split(y[t], w[t], d[t], cc[t]);
    __syncwarp();
    k3_rounds_out<T, RND>(d, cc, w, k.rounds, tx, e);
    __syncwarp();
    // b: publish, or write the unit's out-carries
    if (pos < tpu - 1) {
        if (tx < R) {
#pragma unroll
            for (int t = 0; t < T; ++t)
                edge[((size_t)tile * L + ty + 8 * t) * R + tx] =
                    e[8 * t * AX_TC + tx];
        }
        __syncthreads();
        if (lead) k3_st_release(flag + tile, mark);
    } else if (tx == 0) {
        const int units = g.C / k.ct;
#pragma unroll
        for (int t = 0; t < T; ++t) {
            u64 acc = 0;
            for (int r = 0; r < R; ++r) acc += e[8 * t * AX_TC + r];
            k.co[((size_t)(ty + 8 * t) * g.S + s) * units + cb / tpu] = acc;
        }
    }
    // c: the tile before's words in; a unit's first tile has a's digits
    if (pos > 0) {
        if (lead) {
            const u64 t0 = k3_now();
            while (k3_ld_acquire(flag + tile - 1) != mark) {
                __nanosleep(64);
                if (k3_now() - t0 > K3_WAIT_NS) __trap();
            }
        }
        __syncthreads();
        if (tx < R) {
#pragma unroll
            for (int t = 0; t < T; ++t)
                e[8 * t * AX_TC + tx] = __ldcg(
                    edge + ((size_t)(tile - 1) * L + ty + 8 * t) * R + tx);
        }
        __syncwarp();
        k3_rounds_in<T, RND>(d, y, w, k.rounds, tx, e);
    }
    // d
#pragma unroll
    for (int t = 0; t < T; ++t) g.out[base + (ty + 8 * t) * rs] = d[t];
}

template <int LL, int RND>
int k3_launch(const K3Args& k, int ntiles, cudaStream_t st) {
    k3_kernel<LL, RND><<<ntiles, dim3(AX_TC, AX_TY), 0, st>>>(k);
    return (int)cudaGetLastError();
}

// The plans' rounds (2 to 4: fourstep.carry_rounds) unrolled, any other
// count in a loop.
template <int LL>
int k3_launch_rounds(const K3Args& k, int ntiles, cudaStream_t st) {
    switch (k.rounds) {
    case 2: return k3_launch<LL, 2>(k, ntiles, st);
    case 3: return k3_launch<LL, 3>(k, ntiles, st);
    case 4: return k3_launch<LL, 4>(k, ntiles, st);
    }
    return k3_launch<LL, 0>(k, ntiles, st);
}

}  // namespace

// scratch: scratch_words u64, zero when first given, then left to the
// kernel (the ticket, the epoch, the flags and the edge words); one
// scratch a stream at a time. Returns cudaGetLastError(), or -1 for a
// shape the launch does not take.
extern "C" int prmers_k3_p7c(const u64* x, u64* out, u64* co,
                             const u64* rs, const u32* er, const u32* ec,
                             u32 n, const u32* widths, int rounds, u64 a,
                             int with_a, int sub2, u64 s2, int L1, int R2,
                             int C, int ct, u64* scratch,
                             long long scratch_words,
                             void* stream) {
    // a unit is whole tiles; the edge words of a round leave lane 31
    // before any word from the tile before can reach it
    if (ct < 256 || ct > 4096 || (ct & (ct - 1)) || C % ct) return -1;
    if (rounds < 1 || rounds + 1 > K3_TW || scratch == nullptr) return -1;
    const long long ntiles = (long long)R2 * (C / AX_TC);
    if (scratch_words < K3_HDR + ntiles * (1 + L1 * (rounds + 1)))
        return -1;
    K3Args k = {};
    k.g.x = x;
    k.g.out = out;
    k.g.rs = rs;
    k.g.er = er;
    k.g.ec = ec;
    k.g.n = n;
    k.g.a = a;
    k.g.with_a = with_a;
    k.g.O = 1;
    k.g.L = L1;
    k.g.S = R2;
    k.g.C = C;
    k.co = co;
    k.widths = widths;
    k.rounds = rounds;
    k.sub2 = sub2;
    k.s2 = s2;
    k.ct = ct;
    k.scratch = scratch;
    cudaStream_t st = (cudaStream_t)stream;
    switch (L1) {
    case 32: return k3_launch_rounds<5>(k, (int)ntiles, st);
    case 64: return k3_launch_rounds<6>(k, (int)ntiles, st);
    }
    return -1;
}
