"""PRP / Lucas-Lehmer / Wagstaff test driver with Gerbicz-Li error checking.

Algorithm parity with the reference PRP/LL mode
(reference: src/modes/RunPrpOrLlMarin.cpp:97-520):
  * PRP: R0 = 3, p squarings; prime iff final == 9; reported residue is the
    Fermat residue final/9 (CRT branch when 9 | M_p).
  * LL: R0 = 4, p-2 iterations of x^2 - 2; prime iff 0 or M_p.
  * Wagstaff (exponent 2q): q squarings mod M_{2q}; PRP iff residue mod
    (2^q + 1) == 9.
  * Gerbicz-Li: B = floor(sqrt(p)); accumulator R1 multiplied by R0 at block
    boundaries; every `checkpasslevel` blocks the accumulator relation
    R1_new == R3^(2^B) * 3 is replayed and verified; mismatch restores the
    last-good snapshot (R4, R5) and rewinds.

The hot loop is restructured into chunked `square_mul_seq` dispatches (one XLA
scan per block) instead of the reference's per-iteration enqueues.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import time

from ..core import checkpoints as ck
from ..core import results as res
from ..utils import gmp
from ..core.progress import Progress
from ..core.quickcheck import quick_check, validate_exponent
from ..engine.api import Engine
from ..engine.factory import create_engine
from ..io.options import Options

R0, R1, R2, R3, R4, R5, RBASE, RTMP = range(8)


@dataclasses.dataclass
class PrpLlResult:
    p: int
    mode: str
    is_prime: bool
    res64: str = ""
    res2048: str = ""
    transform_size: int = 0
    elapsed: float = 0.0
    gerbicz_errors: int = 0
    interrupted: bool = False
    iteration: int = 0
    quick: bool = False
    wagstaff_prp: bool | None = None
    cofactor_prp: bool | None = None


def _gl_extra_pack(itersave, jsave, checkpass, errcount):
    return struct.pack("<QQQI", itersave, jsave, checkpass, errcount)


def _gl_extra_unpack(b):
    if len(b) != struct.calcsize("<QQQI"):
        return None
    return struct.unpack("<QQQI", b)


def run_prp_or_ll(opts: Options, eng: Engine | None = None,
                  proof_set=None, log=print) -> PrpLlResult:
    p = opts.exponent
    validate_exponent(p)
    mode = opts.mode
    assert mode in ("prp", "ll")

    qc = quick_check(p) if not opts.wagstaff else None
    if qc is not None:
        return PrpLlResult(p=p, mode=mode, is_prime=qc, quick=True)

    if eng is None:
        eng = create_engine(p, 8, backend=opts.backend,
                            arith=opts.arith, workload="prp")
    n = eng.get_size()
    mp = res.mersenne(p)
    if opts.verbose:
        name = "LL-UNSAFE" if mode == "ll" else "PRP"
        log(f"{name} on 2^{p} - 1 using {type(eng).__name__} with {n} words")

    total_iters = p if mode == "prp" else p - 2
    if opts.wagstaff:
        assert p % 2 == 0, "wagstaff needs an even driver exponent 2q"
        total_iters //= 2

    mode_tag = ck.MODE_TAGS["wagstaff" if opts.wagstaff else mode]
    ckpt_path = ck.ckpt_filename(p, mode, opts.wagstaff, opts.save_dir)

    # ---- resume -------------------------------------------------------
    resume_iter = 0
    restored_time = 0.0
    itersave, jsave, checkpass = 0, total_iters - 1, 0
    saved = ck.load_latest(ckpt_path, p, mode_tag)
    if saved is not None:
        try:
            eng.set_checkpoint(saved.regs)
            resume_iter = saved.iteration
            restored_time = saved.elapsed
            gl = _gl_extra_unpack(saved.extra)
            if gl:
                _, _, _, opts.gerbicz_error_count = gl
            # R4/R5 are re-seeded from the restored R0/R1 below, so the
            # last-good marker must point at the restored iteration
            itersave = resume_iter - 1 if resume_iter > 0 else 0
            jsave = total_iters - resume_iter
            log("Resuming from a checkpoint.")
        except (AssertionError, ValueError):
            saved = None
    if saved is None:
        eng.set(R1, 1)
        eng.set(R0, 3 if mode == "prp" else 4)
    eng.copy(R4, R0)   # last correct state
    eng.copy(R5, R1)   # last correct accumulator
    eng.set(RBASE, 3)
    eng.set_multiplicand(RTMP, RBASE)

    B = max(int(math.isqrt(p)), 2)
    checkpasslevel = opts.checklevel
    if checkpasslevel <= 0:
        checkpasslevel = int((1000 * 600.0) / B)
        if checkpasslevel == 0:
            checkpasslevel = (total_iters // B) // max(int(math.isqrt(B)), 1)
        if checkpasslevel == 0:
            checkpasslevel = 1

    progress = Progress(total_iters, label=f"M{p}")
    start_clock = time.monotonic()
    last_backup = start_clock

    def save_ckpt(iteration: int):
        elapsed = time.monotonic() - start_clock + restored_time
        ck.write_checkpoint(ckpt_path, ck.CheckpointData(
            p=p, mode_tag=mode_tag, iteration=iteration, elapsed=elapsed,
            extra=_gl_extra_pack(itersave, jsave, checkpass,
                                 opts.gerbicz_error_count),
            regs=eng.get_checkpoint()))

    error_injected = False
    iteration = resume_iter
    last_failed_restore = -1
    use_gl = (mode == "prp") and opts.gerbiczli

    try:
        while iteration < total_iters:
            j = total_iters - 1 - iteration
            # chunk so the LAST executed iteration lands on a GL boundary
            # (j_last % B == 0): chunk == (j+1) mod B, or B if that is 0
            if use_gl:
                chunk = (j + 1) % B
                if chunk == 0:
                    chunk = B
                chunk = min(chunk, total_iters - iteration)
            else:
                chunk = min(total_iters - iteration, 4096)
            # split at error-injection point
            if opts.erroriter > 0 and not error_injected:
                to_err = opts.erroriter - iteration
                if 0 < to_err <= chunk:
                    chunk = to_err
            # split at proof checkpoints
            if proof_set is not None:
                nxt = proof_set.next_checkpoint_after(iteration)
                if nxt is not None and nxt - iteration < chunk:
                    chunk = max(nxt - iteration, 1)
            # split at res64 display boundaries
            ivl = opts.res64_display_interval
            if ivl > 0:
                nxt = (iteration // ivl + 1) * ivl
                if nxt - iteration < chunk:
                    chunk = max(nxt - iteration, 1)
            assert chunk >= 1

            if mode == "ll":
                eng.square_sub2_seq(R0, chunk)
            else:
                eng.square_mul_seq(R0, [1] * chunk)
            iteration += chunk
            j = total_iters - 1 - (iteration - 1)

            if (opts.erroriter > 0 and iteration == opts.erroriter
                    and not error_injected):
                error_injected = True
                eng.sub(R0, 2)
                log(f"Injected error at iteration {iteration}")

            if proof_set is not None and iteration < total_iters and \
                    proof_set.should_checkpoint(iteration):
                # engine-aware: multi-host mesh runs shard the residue
                # instead of gathering it through the primary
                proof_set.checkpoint_engine(eng, iteration, R0)

            if (opts.res64_display_interval > 0
                    and iteration % opts.res64_display_interval == 0):
                # reference format: src/opencl kernel_res64_display output
                r64 = eng.get_int(R0) & 0xFFFFFFFFFFFFFFFF
                log(f"Iter: {iteration}| Res64: {r64:016X}")

            at_boundary = use_gl and ((j != 0 and j % B == 0)
                                      or iteration == total_iters)
            if at_boundary:
                checkpass += 1
                eng.copy(R3, R1)
                eng.set_multiplicand(R2, R0)
                eng.mul(R1, R2)
                if checkpass == checkpasslevel or iteration == total_iters:
                    checkpass = 0
                    # the accumulator's first factor is 3^(2^s) with s the
                    # length of the first (possibly partial) GL block, so the
                    # replay folds the x3 in s squarings before the end
                    modb = B if total_iters % B == 0 else total_iters % B
                    loop_count = B - modb - 1 if B > modb else 0
                    eng.square_mul_seq(R3, [1] * loop_count)
                    if total_iters % B == 0:
                        eng.mul(R3, RTMP)
                    else:
                        eng.square_mul(R3, 3)
                    eng.square_mul_seq(R3, [1] * modb)
                    ok = (eng.get_int(R3) % mp) == (eng.get_int(R1) % mp)
                    if not ok:
                        if iteration == last_failed_restore:
                            raise RuntimeError(
                                "Gerbicz-Li check failed repeatedly with no "
                                "forward progress — aborting")
                        last_failed_restore = iteration
                        log("[Gerbicz Li] Mismatch")
                        log(f"[Gerbicz Li] Check FAILED! iter={iteration}")
                        log(f"[Gerbicz Li] Restore iter={itersave} (j={jsave})")
                        opts.gerbicz_error_count += 1
                        eng.copy(R0, R4)
                        eng.copy(R1, R5)
                        iteration = itersave + 1 if itersave > 0 else 0
                        continue
                    else:
                        log(f"[Gerbicz Li] Check passed! iter={iteration}")
                        eng.copy(R4, R0)
                        eng.copy(R5, R1)
                        itersave = iteration - 1
                        jsave = total_iters - iteration

            now = time.monotonic()
            if now - last_backup >= opts.backup_interval:
                save_ckpt(iteration)
                last_backup = now
            progress.maybe_display(iteration)
    except KeyboardInterrupt:
        save_ckpt(iteration)
        log(f"\nInterrupted by user, state saved at iteration {iteration}")
        return PrpLlResult(p=p, mode=mode, is_prime=False,
                           interrupted=True, iteration=iteration,
                           transform_size=n, elapsed=progress.elapsed())

    if proof_set is not None:
        proof_set.checkpoint_engine(eng, total_iters, R0)

    # ---- final residue ------------------------------------------------
    if mode == "ll":
        is_prime = eng.digit_equal_to(R0, 0) or eng.digit_equal_to_mp(R0)
    else:
        is_prime = eng.digit_equal_to(R0, 9)

    x = eng.get_int(R0)
    wag = None
    cofactor_prp = None
    if opts.wagstaff:
        fp = (1 << (p // 2)) + 1
        wag = (x % fp) == 9
        is_prime = False
    if mode == "prp" and opts.known_factors:
        # type-5 cofactor PRP (reference: src/math/Cofactor.cpp:9-67):
        # with KF = prod(known factors), C = M_p / KF, and x = 3^(2^p):
        # 3^(M_p - 1) = x/9, and C is PRP iff x/9 ≡ 3^(KF-1) (mod C).
        kf = 1
        for f in opts.known_factors:
            fi = int(f)
            if mp % fi != 0:
                raise ValueError(f"known factor {fi} does not divide M_{p}")
            kf *= fi
        assert mp % kf == 0, "known factors are not coprime"
        c = mp // kf
        lhs = gmp.mulmod(x, gmp.invert(9, mp), mp) % c
        cofactor_prp = lhs == gmp.powmod(3, kf - 1, c)
        is_prime = False
    if mode == "prp":
        r = res.prp_residue(p, x)
    else:
        r = x
    result = PrpLlResult(
        p=p, mode=mode, is_prime=is_prime,
        res64=res.res64_hex(r), res2048=res.res2048_hex(r),
        transform_size=n, elapsed=progress.elapsed() + restored_time,
        gerbicz_errors=opts.gerbicz_error_count,
        iteration=total_iters, wagstaff_prp=wag,
        cofactor_prp=cofactor_prp)
    ck.delete_checkpoints(ckpt_path)
    return result
