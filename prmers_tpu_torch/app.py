"""`python -m prmers_tpu_torch <p> [-ll | -llsafe | -llsafe2]`: a PRP, LL
or LL-safe run on the port.

Counterpart of prmers_tpu/core/app.py:92-150. It parses with the port's
copy of the CLI (io/cli.parse_args), runs its copy of the PRP/LL driver
(modes/prp_ll.run_prp_or_ll) or of the LL-safe modes (modes/llsafe) on
the port's engine, and prints the PrimeNet result JSON (io/json_out). A
PRP of p > 128 writes its GIMPS proof (core/proof, power -proofpower or
best_power(p); -noproof skips it), logs its hashes, puts its power and
the md5 of the file in the JSON, and verifies it under -proofverify, as
prmers_tpu/core/app.py:96-121 does. As prmers_tpu/core/app.py:270-274 and
:293 do, rank 0 appends that line to the results file (`-results`,
default results.txt), writes it to `<save_dir>/<p>_<mode>_result.json`
(io/worktodo, a copy of the JAX package's) and tees its log to
`<save_dir>/prmers.log` (LogTee). Other modes, the second arithmetic
(`-arith fft3161`, its `-pfa*` aliases, PRMERS_ARITH=fft3161),
`-profile`, `-filemers` (the .mers to GMP-ECM conversion) and `-gui` (the
web GUI) are not ported yet and stop with a message saying so, before any
engine is made, rather than run a PRP under a flag that asked otherwise.

Under torchrun (or the JAX package's PRMERS_COORDINATOR variables) each
process joins the group first (parallel/dist.init_from_env, as
prmers_tpu/core/app.py:291 does), and `-backend sharded` (or "auto" with
more than one rank) runs the mesh engine on it, one card per process:
`python -m torch.distributed.run --nproc_per_node=4 -m prmers_tpu_torch
<p> -noproof -backend sharded`. Only rank 0 prints the log and the result
and writes checkpoints and proofs.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time

from .core.proof import ProofSet, best_power
from .engine.factory import create_engine
from .io import json_out
from .io.cli import parse_args
from .io.worktodo import append_results_txt, write_individual_json
from .modes.llsafe import LLSAFE2_REGS, LLSAFE_REGS, run_llsafe, run_llsafe2
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


def run(opts, device=None, log=print):
    """One PRP, LL or LL-safe run; returns (result, json_line)."""
    if opts.filemers or opts.gui:
        raise SystemExit(f"{'-filemers' if opts.filemers else '-gui'} is "
                         "not yet ported to prmers_tpu_torch")
    if opts.mode not in ("prp", "ll", "llsafe", "llsafe2"):
        raise SystemExit(f"mode {opts.mode!r} is not yet ported to "
                         "prmers_tpu_torch (PRP, LL and LL-safe only)")
    if "fft3161" in (opts.arith, os.environ.get("PRMERS_ARITH")):
        raise SystemExit("the fft3161 arithmetic (-arith fft3161, -pfa*, "
                         "PRMERS_ARITH) is not yet ported to "
                         "prmers_tpu_torch (Goldilocks only)")
    if opts.profile:
        raise SystemExit("-profile is not yet ported to prmers_tpu_torch; "
                         "python -m prmers_tpu_torch.profile <p> profiles "
                         "the kernels")
    if opts.save_dir:
        os.makedirs(opts.save_dir, exist_ok=True)
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


def main(argv=None) -> int:
    opts = parse_args(argv)
    if opts.exponent == 0:
        print("usage: python -m prmers_tpu_torch <p> [-ll] [-noproof]")
        return 2
    dist.init_from_env()
    try:
        if dist.is_primary():
            os.makedirs(opts.save_dir, exist_ok=True)
            log = LogTee(os.path.join(opts.save_dir, "prmers.log"))
            try:
                r, j = run(opts, log=log)
                append_results_txt(opts.results_path, j)
                write_individual_json(opts.save_dir, opts.exponent,
                                      opts.mode, j)
                log(j)
            finally:
                log.close()
        else:
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null):
                r, j = run(opts)
    finally:
        dist.shutdown()
    prime = bool(r.is_prime or getattr(r, "wagstaff_prp", None)
                 or getattr(r, "cofactor_prp", None))
    return 0 if prime else 1
