"""Lucas-Lehmer with error checking (LL-safe): the √3-split representation.

Algorithm parity with the reference LL-safe mode
(reference: src/modes/RunLlSafeMarin.cpp:394-530, pair_square :483-505).

Classic LL iterates S <- S^2 - 2, which has no multiplicative structure, so
Gerbicz-style checks don't apply. LL-safe instead tracks
w^(2^k) = a + b*sqrt(3) in Z[sqrt(3)]/M_p with w = 2 + sqrt(3): squaring
the pair IS the LL step (S_k = 2 a_k since norm(w) = 1), and pair products
are multiplicative, enabling the same product-accumulator verification as
PRP: over a window, (prod s_k)^(2^B) == prod s_{k+1}.

pair_square: (a, b) -> (a^2 + 3 b^2, 2ab) with 2ab = (a+b)^2 - a^2 - b^2
(3 squarings, no general mul). pair_mul (accumulators):
(a1 a2 + 3 b1 b2, a1 b2 + a2 b1).

Prime iff a_{p-2} ≡ 0 (mod M_p).
"""

from __future__ import annotations

import dataclasses
import math
import time

from ..core import results as res
from ..core.progress import Progress
from ..core.quickcheck import quick_check, validate_exponent
from ..engine.api import Engine
from ..engine.factory import create_engine
from ..io.options import Options

# register map: the state pair, squaring temps, GL accumulator pairs,
# last-good snapshots, and multiplicand scratch
(RA, RB, T1, T2, T3, LA, LB, RRA, RRB, SA, SB, SLA, SLB, SRA, SRB,
 MUL, RPA, RPB) = range(18)
LLSAFE_REGS = 18  # same register count as the reference LL-safe mode


@dataclasses.dataclass
class LlSafeResult:
    p: int
    is_prime: bool
    res64: str = ""
    transform_size: int = 0
    elapsed: float = 0.0
    gerbicz_errors: int = 0
    iteration: int = 0
    quick: bool = False


def _pair_square(eng: Engine, a: int, b: int):
    """(a, b) <- (a^2 + 3 b^2, 2ab) using T1..T3."""
    eng.copy(T1, a)
    eng.square_mul(T1)          # a^2
    eng.copy(T2, b)
    eng.square_mul(T2)          # b^2
    eng.copy(T3, a)
    eng.add(T3, b)
    eng.square_mul(T3)          # (a+b)^2
    eng.sub_reg(T3, T1)
    eng.sub_reg(T3, T2)         # 2ab
    eng.copy(a, T1)
    eng.add(a, T2)
    eng.add(a, T2)
    eng.add(a, T2)              # a^2 + 3 b^2
    eng.copy(b, T3)


def _pair_mul(eng: Engine, da: int, db: int, sa: int, sb: int):
    """(da, db) <- (da, db) * (sa, sb) using T1..T3 + MUL scratch."""
    eng.set_multiplicand(MUL, sa)
    eng.copy(T1, da)
    eng.mul(T1, MUL)            # a1 a2
    eng.copy(T3, db)
    eng.mul(T3, MUL)            # b1 a2
    eng.set_multiplicand(MUL, sb)
    eng.copy(T2, db)
    eng.mul(T2, MUL)            # b1 b2
    eng.mul(da, MUL)            # a1 b2 (into da temporarily)
    eng.add(da, T3)             # a1 b2 + a2 b1 -> new b
    eng.copy(db, da)
    eng.copy(da, T1)
    eng.add(da, T2)
    eng.add(da, T2)
    eng.add(da, T2)             # a1 a2 + 3 b1 b2
    # swap: new pair is (da, db) with db holding the sum computed above
    # (da currently new-a, db new-b) — already in place.


def run_llsafe(opts: Options, eng: Engine | None = None,
               log=print) -> LlSafeResult:
    p = opts.exponent
    validate_exponent(p)
    qc = quick_check(p)
    if qc is not None:
        return LlSafeResult(p=p, is_prime=qc, quick=True)

    if eng is None:
        eng = create_engine(p, LLSAFE_REGS, backend=opts.backend,
                            arith=opts.arith, workload="ll")
    n = eng.get_size()
    mp = res.mersenne(p)
    total = p - 2
    log(f"LL-SAFE on 2^{p} - 1 with {n} words")

    eng.set(RA, 2)
    eng.set(RB, 1)              # w = 2 + sqrt(3)
    eng.set(LA, 1)
    eng.set(LB, 0)
    eng.set(RRA, 1)
    eng.set(RRB, 0)
    eng.copy(SA, RA)
    eng.copy(SB, RB)
    eng.copy(SLA, LA)
    eng.copy(SLB, LB)
    eng.copy(SRA, RRA)
    eng.copy(SRB, RRB)

    B = max(int(math.isqrt(total)), 16)
    use_gl = opts.gerbiczli and total >= 4 * B
    checkpass = opts.checklevel if opts.checklevel > 0 else \
        max(min(int(600.0 * 100 / B), max(total // B, 1)), 1)

    progress = Progress(total, label=f"M{p} llsafe")
    t0 = time.monotonic()
    it = 0
    good_it = 0
    blocks = 0
    retries = 0
    error_injected = False
    while it < total:
        if use_gl:
            # accumulate L with the state at block start
            _pair_mul(eng, LA, LB, RA, RB)
        chunk = min(B, total - it) if use_gl else min(total - it, 4096)
        for _ in range(chunk):
            _pair_square(eng, RA, RB)
        it += chunk
        if opts.erroriter and not error_injected and it >= opts.erroriter:
            eng.sub(RA, 1)
            error_injected = True
            log(f"Injected error at iteration {it}")
        if use_gl:
            _pair_mul(eng, RRA, RRB, RA, RB)
            blocks += 1
            if blocks % checkpass == 0 or it >= total:
                if chunk == B:
                    # replay: (LA,LB)^(2^B) == (RRA,RRB)
                    eng.copy(RPA, LA)
                    eng.copy(RPB, LB)
                    for _ in range(B):
                        _pair_square(eng, RPA, RPB)
                    ok = (eng.get_int(RPA) % mp == eng.get_int(RRA) % mp and
                          eng.get_int(RPB) % mp == eng.get_int(RRB) % mp)
                else:
                    ok = True  # tail block shorter than B: skip check
                if ok:
                    log(f"[Gerbicz Li] Check passed! iter={it}")
                    eng.copy(SA, RA)
                    eng.copy(SB, RB)
                    eng.copy(SLA, LA)
                    eng.copy(SLB, LB)
                    eng.copy(SRA, RRA)
                    eng.copy(SRB, RRB)
                    good_it = it
                    retries = 0
                else:
                    retries += 1
                    opts.gerbicz_error_count += 1
                    log(f"[Gerbicz Li] Check FAILED! iter={it} — "
                        f"restore iter={good_it}")
                    if retries > 2:
                        raise RuntimeError("LL-safe check failing repeatedly")
                    eng.copy(RA, SA)
                    eng.copy(RB, SB)
                    eng.copy(LA, SLA)
                    eng.copy(LB, SLB)
                    eng.copy(RRA, SRA)
                    eng.copy(RRB, SRB)
                    it = good_it
                    error_injected = True  # injected fault now cleared
        progress.maybe_display(it)

    a = eng.get_int(RA) % mp
    is_prime = (a == 0)
    s_final = (2 * a) % mp
    return LlSafeResult(
        p=p, is_prime=is_prime, res64=res.res64_hex(s_final),
        transform_size=n, elapsed=time.monotonic() - t0,
        gerbicz_errors=opts.gerbicz_error_count, iteration=total)


# ---------------------------------------------------------------------------
# LL-safe2: block-replay verification on the (V, U) companion pair
# (reference: App::runLlSafeMarinDoubling, src/modes/RunLlSafeMarin.cpp:95-330)
# ---------------------------------------------------------------------------

# register map for llsafe2 (8 regs like the reference)
(L2V, L2U, L2VC, L2UC, L2TMP, L2VCHK, L2UCHK, L2SCR) = range(8)
LLSAFE2_REGS = 8


def _ll2_step(eng: Engine, v: int, u: int, tmp: int):
    """U <- U*V; V <- V^2 - 2 (the reference's coupled iteration)."""
    eng.set_multiplicand(tmp, v)
    eng.mul(u, tmp)
    eng.square_mul(v)
    eng.sub(v, 2)


def run_llsafe2(opts: Options, eng: Engine | None = None,
                log=print) -> LlSafeResult:
    """LL with block-replay error detection: V follows the LL sequence
    (V0 = 4), U accumulates prod(V_i) (U0 = 2) so any transient error
    persists into U; every block is recomputed from the last verified
    snapshot into check registers and both sequences compared exactly.
    Mismatch restores the snapshot and rewinds (block size -llsafeb,
    default floor(sqrt(p)) like the reference's p/sqrt(p))."""
    p = opts.exponent
    validate_exponent(p)
    qc = quick_check(p)
    if qc is not None:
        return LlSafeResult(p=p, is_prime=qc, quick=True)

    if eng is None:
        eng = create_engine(p, LLSAFE2_REGS, backend=opts.backend,
                            arith=opts.arith, workload="ll")
    n = eng.get_size()
    mp = res.mersenne(p)
    total = p - 2
    log(f"LL-SAFE2 on 2^{p} - 1 with {n} words")

    eng.set(L2V, 4)
    eng.set(L2U, 2)
    eng.copy(L2VC, L2V)
    eng.copy(L2UC, L2U)

    B = opts.llsafe_block if opts.llsafe_block > 0 else \
        max(int(math.isqrt(max(total, 1))), 1)
    B = min(B, total) if total else 1

    progress = Progress(total, label=f"M{p} llsafe2")
    t0 = time.monotonic()
    it = 0
    itersave = 0
    retries = 0
    error_injected = False
    while it < total:
        blk = min(B, total - it)
        for _ in range(blk):
            _ll2_step(eng, L2V, L2U, L2TMP)
        it += blk
        if opts.erroriter and not error_injected and it >= opts.erroriter:
            eng.sub(L2V, 2)
            error_injected = True
            log(f"Injected error at iteration {it}")
        # replay the block from the snapshot and compare both sequences
        eng.copy(L2VCHK, L2VC)
        eng.copy(L2UCHK, L2UC)
        for _ in range(blk):
            _ll2_step(eng, L2VCHK, L2UCHK, L2TMP)
        ok = (eng.get_int(L2VCHK) % mp == eng.get_int(L2V) % mp and
              eng.get_int(L2UCHK) % mp == eng.get_int(L2U) % mp)
        if ok:
            log(f"[Error check] Check passed! iter={it}")
            eng.copy(L2VC, L2V)
            eng.copy(L2UC, L2U)
            itersave = it
            retries = 0
        else:
            retries += 1
            opts.gerbicz_error_count += 1
            log(f"[Error check] Check FAILED! iter={it} — "
                f"restore iter={itersave}")
            if retries > 2:
                raise RuntimeError("LL-safe2 check failing repeatedly")
            eng.copy(L2V, L2VC)
            eng.copy(L2U, L2UC)
            it = itersave
            error_injected = True  # injected fault now cleared
        progress.maybe_display(it)

    v = eng.get_int(L2V) % mp
    return LlSafeResult(
        p=p, is_prime=(v == 0), res64=res.res64_hex(v),
        transform_size=n, elapsed=time.monotonic() - t0,
        gerbicz_errors=opts.gerbicz_error_count, iteration=total)
