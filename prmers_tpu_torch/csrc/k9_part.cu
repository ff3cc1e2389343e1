// K9 for the pass profiler (tools/profile_passes --k9) and the smoke's
// timing alone: the kernel of k9_chain.cuh in a given row form, its
// move-only body, its grid barriers alone, or one phase alone between
// them. The engine never calls it.

#include "k9_chain.cuh"

enum { K9_RULE = 0, K9_FUSED = 1, K9_SPLIT = 2 };

template <int LL1, int LL2>
int k9_part(ChainArgs& g, int part, int phases, int form, cudaStream_t st) {
    constexpr bool RULE = k9_split(LL1, LL2);
    if (part == K9_MOVE)
        return phases == K9_ALL && form == K9_RULE
                   ? k9_launch<LL1, LL2, K9_MOVE, K9_ALL, RULE>(g, st)
                   : -1;
    if (phases == K9_ALL) {
        if (form == K9_FUSED)
            return k9_launch<LL1, LL2, K9_FULL, K9_ALL, false>(g, st);
        if (form == K9_SPLIT)
            return k9_launch<LL1, LL2, K9_FULL, K9_ALL, true>(g, st);
        return k9_launch<LL1, LL2, K9_FULL, K9_ALL, RULE>(g, st);
    }
    if (form != K9_RULE) return -1;
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

// prmers_k9_chain's arguments, then part (K9_FULL, or K9_MOVE with all
// phases in the rule's form), phases (all: 63; none: 0, the barriers
// alone; or one bit, phase p + 1 alone; at L2 = 1 bits 1 and 3 select
// nothing, the row phase holding K2a and K2c) and form (K9_RULE, or with
// all phases K9_FUSED or K9_SPLIT). Returns as prmers_k9_chain.
extern "C" int prmers_k9_chain_part(
    u64* x, u64* co, const u64* a, int count, const u64* k1_cs,
    const u64* k1_rs, const u32* wt, const u32* cum, int kk, const u32* er,
    const u32* ec, u32 n, const u64* mf, const u64* mi, const u64* t_r_inv,
    const u64* cs_f, const u64* cs_i, const u64* k3_rs, const u32* widths,
    int rounds, int L1, int R2, int C, int part, int phases, int form,
    void* stream) {
    if ((part != K9_FULL && part != K9_MOVE) || form < K9_RULE ||
        form > K9_SPLIT)
        return -1;
    ChainArgs g;
    const int err = k9_args(g, x, co, a, count, k1_cs, k1_rs, wt, cum, kk,
                            er, ec, n, mf, mi, t_r_inv, cs_f, cs_i, k3_rs,
                            widths, rounds, C);
    if (err || count == 0) return err;
    cudaStream_t st = (cudaStream_t)stream;
    return k9_shape(L1, R2, [&](auto l1, auto l2) {
        return k9_part<decltype(l1)::value, decltype(l2)::value>(
            g, part, phases, form, st);
    });
}
