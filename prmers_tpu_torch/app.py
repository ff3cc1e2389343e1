"""`python -m prmers_tpu_torch <p> [-ll]`: a PRP or LL run on the port.

Counterpart of prmers_tpu/core/app.py:92-124. It parses with the port's
copy of the CLI (io/cli.parse_args), runs its copy of the PRP/LL driver
(modes/prp_ll.run_prp_or_ll) on the port's engine, and prints the
PrimeNet result JSON (io/json_out). As prmers_tpu/core/app.py:270-274 and
:293 do, rank 0 appends that line to the results file (`-results`,
default results.txt), writes it to `<save_dir>/<p>_<mode>_result.json`
(io/worktodo, a copy of the JAX package's) and tees its log to
`<save_dir>/prmers.log` (LogTee). Other modes, PRP proofs, the second
arithmetic (`-arith fft3161`, its `-pfa*` aliases, PRMERS_ARITH=fft3161),
`-profile`, `-filemers` (the .mers to GMP-ECM conversion) and `-gui` (the
web GUI) are not ported yet and stop with a message saying so, before any
engine is made, rather than run a PRP under a flag that asked otherwise.

Under torchrun (or the JAX package's PRMERS_COORDINATOR variables) each
process joins the group first (parallel/dist.init_from_env, as
prmers_tpu/core/app.py:291 does), and `-backend sharded` (or "auto" with
more than one rank) runs the mesh engine on it, one card per process:
`python -m torch.distributed.run --nproc_per_node=4 -m prmers_tpu_torch
<p> -noproof -backend sharded`. Only rank 0 prints the log and the result
and writes checkpoints.
"""

from __future__ import annotations

import contextlib
import os
import time

from .engine.factory import create_engine
from .io import json_out
from .io.cli import parse_args
from .io.worktodo import append_results_txt, write_individual_json
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
    """One PRP/LL run; returns (result, json_line)."""
    if opts.filemers or opts.gui:
        raise SystemExit(f"{'-filemers' if opts.filemers else '-gui'} is "
                         "not yet ported to prmers_tpu_torch")
    if opts.mode not in ("prp", "ll"):
        raise SystemExit(f"mode {opts.mode!r} is not yet ported to "
                         "prmers_tpu_torch (PRP and LL only)")
    if (opts.mode == "prp" and opts.proof and not opts.wagstaff
            and opts.exponent > 128):
        raise SystemExit("PRP proof generation is not yet ported to "
                         "prmers_tpu_torch; pass -noproof")
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
    eng = create_engine(opts.exponent, 8, device=device,
                        backend=opts.backend, arith=opts.arith,
                        workload="prp")
    r = run_prp_or_ll(opts, eng=eng, proof_set=None, log=log)
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
    prime = bool(r.is_prime or r.wagstaff_prp or r.cofactor_prp)
    return 0 if prime else 1
