"""`python -m prmers_tpu_torch <p> [mode flags]`: the port's command line,
one run or the worktodo loop.

Counterpart of prmers_tpu/core/app.py:65-297. It parses with the port's
copy of the CLI (io/cli.parse_args) and dispatches to the port's copies
of the mode drivers, each on the port's engine: PRP and LL
(modes/prp_ll), LL-safe (modes/llsafe), P-1 (modes/pm1, all its stage-1
and stage-2 forms), ECM (modes/ecm_edwards, twisted Edwards, unless
-montgomery: modes/ecm), -bench (modes/bench: the exponent ladder and
PRMERS_SCORE) and -memtest (modes/memtest), with their PrimeNet result
JSON built as :152-188 do (io/json_out). A PRP of p > 128 writes its
GIMPS proof (core/proof, power -proofpower or best_power(p); -noproof
skips it), logs its hashes, puts its power and the md5 of the file in the
JSON, and verifies it under -proofverify (:96-121).

With no exponent, run_app takes the entries of the worktodo file
(-worktodo, default worktodo.txt; io/worktodo, a copy of the JAX
package's) one at a time, each merged into the options as :21-35 do, and
removes each once done; -filemers converts a .mers checkpoint into a
GMP-ECM .save (io/interop.convert_mers_to_save). The exit codes are the
reference's (:227-280): 0 for a prime, PRP, factor, or a clean bench or
memtest, 1 otherwise, 2 with nothing to do, 0 after a worktodo loop. Rank
0 appends each result line to the results file (-results, default
results.txt), writes it to `<save_dir>/<p>_<mode>_result.json` and tees
its log to `<save_dir>/prmers.log` (LogTee).

-tune measures both arithmetics over the reference's exponent ladder (up
to the exponent given, if any) and records the rates in the port's tune
file (core/tune.run_tune, -save-dir), which engine/policy.decide_arith
then reads; -arith fft3161 (the -pfa* aliases, PRMERS_ARITH=fft3161)
runs the second arithmetic, engine/engine3161.Engine3161, which may take
an exponent past MAX_EXPONENT (:73-78); every run with an exponent logs
its "Arithmetic path" line (_log_arith_decision, :38-57); -profile wraps
each engine create_engine makes (core/profile) and logs their op counts
and calibrated ms/op when the run ends (:81-89). Not ported yet, and
stopped with a message saying so before any engine is made, rather than
run under a flag that asked otherwise: -gui (the web GUI; ROADMAP queue
1 item 9).

Under torchrun (or the JAX package's PRMERS_COORDINATOR variables) each
process joins the group first (parallel/dist.init_from_env, as :291
does), and `-backend sharded` (or "auto" with more than one rank) runs the
mesh engine on it, one card per process: `python -m
torch.distributed.run --nproc_per_node=4 -m prmers_tpu_torch <p> -noproof
-backend sharded`. Only rank 0 prints the log and the result and writes
checkpoints, proofs, results and the worktodo file.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time

from .core.profile import report_all, set_profiling
from .core.proof import ProofSet, best_power
from .core.tune import run_tune
from .engine.factory import create_engine
from .engine.policy import decide_arith
from .io import interop, json_out
from .io.cli import parse_args
from .io.options import Options
from .io.worktodo import (Worktodo, append_results_txt,
                          write_individual_json)
from .modes.bench import run_bench
from .modes.ecm import run_ecm
from .modes.ecm_edwards import run_ecm_edwards
from .modes.llsafe import LLSAFE2_REGS, LLSAFE_REGS, run_llsafe, run_llsafe2
from .modes.memtest import run_memtest
from .modes.pm1 import run_pm1
from .modes.prp_ll import run_prp_or_ll
from .parallel import dist


class LogTee:
    """The log callable: prints each line and appends it, time-stamped, to
    a file (prmers_tpu/core/app.py:196-224; the reference's stdout tee)."""

    def __init__(self, path: str, inner=print):
        self.inner = inner
        self._f = None
        try:
            self._f = open(path, "a", buffering=1)
        except OSError:
            pass

    def __call__(self, *args, **kwargs):
        self.inner(*args, **kwargs)
        if self._f is not None:
            try:
                stamp = time.strftime("%Y-%m-%d %H:%M:%S")
                self._f.write(f"[{stamp}] " +
                              " ".join(str(a) for a in args) + "\n")
            except OSError:
                pass

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


# Largest exponent any plan family carries: the 5*2^26 Goldilocks shape
# at 16 bits/word (prmers_tpu/core/app.py:59-61)
MAX_EXPONENT = 17 * (5 << 26) - 1


def _merge_worktodo(opts: Options, entry) -> Options:
    opts.exponent = entry.exponent
    opts.mode = entry.mode
    opts.aid = entry.aid or opts.aid
    if entry.known_factors:
        opts.known_factors = entry.known_factors
    if entry.b1:
        opts.b1 = entry.b1
    if entry.b2:
        opts.b2 = entry.b2
    if entry.b2_start:
        opts.b2_start = entry.b2_start
    if entry.curves:
        opts.curves = entry.curves
    return opts


def _refuse_unported(opts) -> None:
    """Stop, before any engine, a run that asks for what is not ported."""
    if opts.gui:
        raise SystemExit("-gui is not yet ported to prmers_tpu_torch")


def _log_arith_decision(opts, log) -> None:
    """The "Arithmetic path" line (prmers_tpu/core/app.py:38-57, without
    the GUI card): the forced arithmetic, or decide_arith's choice and
    reason from the tune records in -save-dir."""
    if opts.exponent <= 0 or opts.mode in ("bench", "tune", "memtest"):
        return
    try:
        wl = {"prp": "prp", "ll": "ll", "llsafe": "ll", "llsafe2": "ll",
              "pm1": "pm1_s1", "ecm": "ecm"}.get(opts.mode, "generic")
        d = decide_arith(opts.exponent, wl, opts.save_dir) \
            if opts.arith == "auto" else None
        arith = opts.arith if opts.arith != "auto" else d.arith
        reason = "forced by -arith" if opts.arith != "auto" else d.reason
        log(f"Arithmetic path: {arith} ({reason})" +
            (f" | n_gl64={d.n_gl64} n_3161={d.n_3161} "
             f"ratio={d.ratio:.2f}" if d else ""))
    except Exception:   # telemetry must never block a run
        pass


def run(opts, device=None, log=print):
    """One workload (prmers_tpu/core/app.py:run_once); returns (result,
    json_line), the line empty for -bench, -memtest and -tune."""
    _refuse_unported(opts)
    if opts.save_dir:
        os.makedirs(opts.save_dir, exist_ok=True)
    if opts.exponent > MAX_EXPONENT and opts.arith != "fft3161":
        # forced fft3161 may exceed this (its 3-smooth capacity table
        # extends further); the default gl64 families cannot
        raise SystemExit(
            f"Exponent {opts.exponent} out of range: the largest "
            f"supported transform (5*2^26) caps at {MAX_EXPONENT}")
    set_profiling(bool(opts.profile))
    _log_arith_decision(opts, log)
    try:
        return _run(opts, device, log)
    finally:
        if opts.profile:
            report_all(log)
            set_profiling(False)


def _run(opts, device, log):
    """run's dispatch by mode (prmers_tpu/core/app.py:_run_once_inner)."""
    if opts.mode == "tune":
        return run_tune(opts, log=log, device=device), ""
    if opts.mode == "pm1":
        r = run_pm1(opts, log=log, device=device)
        factors = (str(r.factor),) if r.factor else ()
        j = json_out.build_result_json(
            exponent=opts.exponent, worktype="PM1",
            status="F" if r.factor else "NF",
            b1=opts.b1, b2=opts.b2, factors=factors,
            gerbicz_errors=r.gerbicz_errors,
            fft_length=r.transform_size,
            user=opts.user, computer=opts.computer, aid=opts.aid)
        return r, j
    if opts.mode == "ecm":
        # twisted Edwards unless -montgomery (:165-170)
        ecm = run_ecm_edwards if getattr(opts, "edwards", True) else run_ecm
        r = ecm(opts, log=log, device=device)
        factors = (str(r.factor),) if r.factor else ()
        j = json_out.build_result_json(
            exponent=opts.exponent, worktype="ECM",
            status="F" if r.factor else "NF",
            b1=opts.b1, b2=opts.b2, factors=factors,
            curves=r.curves, curve_seed=opts.curve_seed,
            edwards=False, torsion=opts.torsion, sigma=opts.sigma,
            user=opts.user, computer=opts.computer, aid=opts.aid)
        return r, j
    if opts.mode == "bench":
        return run_bench(opts, log=log, device=device), ""
    if opts.mode == "memtest":
        return run_memtest(opts, log=log, device=device), ""
    if opts.mode not in ("prp", "ll", "llsafe", "llsafe2"):
        raise ValueError(f"unknown mode {opts.mode!r}")
    if opts.mode in ("llsafe", "llsafe2"):
        # prmers_tpu/core/app.py:139-150
        llsafe, regs = ((run_llsafe2, LLSAFE2_REGS) if opts.mode == "llsafe2"
                        else (run_llsafe, LLSAFE_REGS))
        eng = create_engine(opts.exponent, regs, device=device,
                            backend=opts.backend, arith=opts.arith,
                            workload="ll")
        r = llsafe(opts, eng=eng, log=log)
        j = json_out.build_result_json(
            exponent=opts.exponent, worktype="LL",
            status="P" if r.is_prime else "C", res64=r.res64.upper(),
            gerbicz_errors=r.gerbicz_errors, fft_length=r.transform_size,
            user=opts.user, computer=opts.computer, aid=opts.aid)
        return r, j
    eng = create_engine(opts.exponent, 8, device=device,
                        backend=opts.backend, arith=opts.arith,
                        workload="prp")
    proof_set = None
    if (opts.mode == "prp" and opts.proof and not opts.wagstaff
            and opts.exponent > 128):
        power = opts.proof_power or best_power(opts.exponent)
        proof_set = ProofSet(opts.exponent, power, widths=eng.widths,
                             save_dir=opts.save_dir,
                             known_factors=opts.known_factors)
    r = run_prp_or_ll(opts, eng=eng, proof_set=proof_set, log=log)
    proof_md5 = ""
    proof_power = 0
    # rank 0 alone holds the residue files (core/proof.ProofSet.checkpoint)
    if (proof_set is not None and not r.interrupted and not r.quick
            and dist.is_primary()):
        try:
            proof = proof_set.compute_proof(log=log)
            path = proof.save(proof.filename(opts.save_dir))
            log(f"proof written to {path}")
            proof_power = proof.power
            with open(path, "rb") as f:
                proof_md5 = hashlib.md5(f.read()).hexdigest()
            if opts.proof_verify:
                proof.verify(log=log)
        except (OSError, RuntimeError, ValueError) as e:
            log(f"proof generation failed: {e}")
    if opts.mode == "prp" and opts.known_factors:
        status = "PRP" if r.cofactor_prp else "C"
    else:
        status = "P" if r.is_prime else "C"
    if opts.wagstaff:
        status = "PRP" if r.wagstaff_prp else "C"
    j = json_out.build_result_json(
        exponent=opts.exponent,
        worktype="PRP-3" if opts.mode == "prp" else "LL",
        status=status, res64=r.res64.upper(), res2048=r.res2048.upper(),
        gerbicz_errors=r.gerbicz_errors, fft_length=r.transform_size,
        known_factors=opts.known_factors,
        proof_power=proof_power, proof_md5=proof_md5,
        user=opts.user, computer=opts.computer, aid=opts.aid)
    return r, j


def _record(opts, j: str, log) -> None:
    """Rank 0's files for one result line (prmers_tpu/core/app.py:270-274)."""
    if j and dist.is_primary():
        append_results_txt(opts.results_path, j)
        write_individual_json(opts.save_dir, opts.exponent, opts.mode, j)
        log(j)


def run_app(opts, log=print, device=None) -> int:
    """The worktodo loop or one run (prmers_tpu/core/app.py:227-280);
    returns the exit code."""
    if opts.filemers:
        # .mers checkpoint -> GMP-ECM .save (:232-243)
        try:
            out = interop.convert_mers_to_save(opts.filemers)
        except (OSError, ValueError) as e:
            log(f"-filemers failed: {e}")
            return 1
        log(f"GMP ECM file written to: {out}")
        return 0
    wt = Worktodo(opts.worktodo_path)
    entry = wt.first_entry()
    if entry is not None and opts.exponent == 0:
        while entry is not None:
            _merge_worktodo(opts, entry)
            _r, j = run(opts, device=device, log=log)
            _record(opts, j, log)
            if dist.is_primary():
                wt.remove_first_processed()
            dist.barrier()
            entry = wt.first_entry()
        return 0
    if opts.exponent == 0 and opts.mode not in ("bench", "tune", "memtest"):
        log("nothing to do: no exponent and no worktodo entries")
        return 2
    r, j = run(opts, device=device, log=log)
    _record(opts, j, log)
    if opts.mode in ("bench", "tune", "memtest"):
        errs = getattr(r, "errors", 0) + getattr(r, "roundtrip_errors", 0)
        return 0 if not errs else 1
    found = bool(getattr(r, "is_prime", False) or getattr(r, "factor", 0)
                 or getattr(r, "wagstaff_prp", False)
                 or getattr(r, "cofactor_prp", False))
    return 0 if found else 1


def main(argv=None) -> int:
    opts = parse_args(argv)
    dist.init_from_env()
    try:
        if dist.is_primary():
            os.makedirs(opts.save_dir, exist_ok=True)
            log = LogTee(os.path.join(opts.save_dir, "prmers.log"))
            try:
                return run_app(opts, log=log)
            finally:
                log.close()
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            return run_app(opts)
    finally:
        dist.shutdown()
