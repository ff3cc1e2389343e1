// K9's entry point for the engine (kernels.square_chain): the whole chain
// in one cooperative launch at the shape's rule (k9_chain.cuh).

#include "k9_chain.cuh"

// count squarings in place on x (L1, R2, C) and co (L1 * R2,); a holds at
// least count multipliers. Returns a CUDA error code, or -1 for a shape the
// kernel does not take. It raises (through the wrapper) on a card without
// cooperative launch, or when the launch is refused: there is no fallback.
extern "C" int prmers_k9_chain(u64* x, u64* co, const u64* a, int count,
                               const u64* k1_cs, const u64* k1_rs,
                               const u32* wt, const u32* cum, int kk,
                               const u32* er, const u32* ec, u32 n,
                               const u64* mf, const u64* mi,
                               const u64* t_r_inv, const u64* cs_f,
                               const u64* cs_i, const u64* k3_rs,
                               const u32* widths, int rounds, int L1, int R2,
                               int C, void* stream) {
    ChainArgs g;
    const int err = k9_args(g, x, co, a, count, k1_cs, k1_rs, wt, cum, kk,
                            er, ec, n, mf, mi, t_r_inv, cs_f, cs_i, k3_rs,
                            widths, rounds, C);
    if (err || count == 0) return err;
    cudaStream_t st = (cudaStream_t)stream;
    return k9_shape(L1, R2, [&](auto l1, auto l2) {
        constexpr int LL1 = decltype(l1)::value, LL2 = decltype(l2)::value;
        return k9_launch<LL1, LL2, K9_FULL, K9_ALL, k9_split(LL1, LL2)>(g,
                                                                        st);
    });
}
