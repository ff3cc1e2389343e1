// K9 with one phase alone between its grid barriers, or the barriers
// alone, in the rule's form: the single-phase half of
// prmers_k9_chain_part (k9_part.cu), in a source of its own so that its
// instances compile beside the other half's.

#include "k9_chain.cuh"

template <int LL1, int LL2>
int k9_phase(ChainArgs& g, int phases, cudaStream_t st) {
    constexpr bool RULE = k9_split(LL1, LL2);
    switch (phases) {
    case 0: return k9_launch<LL1, LL2, K9_FULL, 0, RULE>(g, st);
    case 1: return k9_launch<LL1, LL2, K9_FULL, 1, RULE>(g, st);
    case 2: return k9_launch<LL1, LL2, K9_FULL, 2, RULE>(g, st);
    case 4: return k9_launch<LL1, LL2, K9_FULL, 4, RULE>(g, st);
    case 8: return k9_launch<LL1, LL2, K9_FULL, 8, RULE>(g, st);
    case 16: return k9_launch<LL1, LL2, K9_FULL, 16, RULE>(g, st);
    case 32: return k9_launch<LL1, LL2, K9_FULL, 32, RULE>(g, st);
    }
    return -1;
}

// prmers_k9_chain's arguments, then phases (0: the barriers alone; one
// bit: phase p + 1 alone). Called by prmers_k9_chain_part only.
extern "C" int prmers_k9_chain_phase(
    u64* x, u64* co, const u64* a, int count, const u64* k1_cs,
    const u64* k1_rs, const u32* wt, const u32* cum, int kk, const u32* er,
    const u32* ec, u32 n, const u64* mf, const u64* mi, const u64* t_r_inv,
    const u64* cs_f, const u64* cs_i, const u64* k3_rs, const u32* widths,
    int rounds, int L1, int R2, int C, int phases, void* stream) {
    ChainArgs g;
    const int err = k9_args(g, x, co, a, count, k1_cs, k1_rs, wt, cum, kk,
                            er, ec, n, mf, mi, t_r_inv, cs_f, cs_i, k3_rs,
                            widths, rounds, C);
    if (err || count == 0) return err;
    cudaStream_t st = (cudaStream_t)stream;
    return k9_shape(L1, R2, [&](auto l1, auto l2) {
        return k9_phase<decltype(l1)::value, decltype(l2)::value>(g, phases,
                                                                  st);
    });
}
