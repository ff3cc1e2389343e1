"""Command-line interface — flag names follow the reference CLI
(reference: include/io/CliParser.hpp:11-145, ~120 options; the subset here
covers every implemented subsystem and grows with them). `-config <file>`
expands file tokens inline before parsing (reference: src/main.cpp:93-110).
"""

from __future__ import annotations

import argparse
import shlex
import sys

from .options import Options


def _expand_config(argv: list[str]) -> list[str]:
    out = []
    i = 0
    while i < len(argv):
        if argv[i] in ("-config", "--config") and i + 1 < len(argv):
            with open(argv[i + 1]) as f:
                out.extend(shlex.split(f.read(), comments=True))
            i += 2
        else:
            out.append(argv[i])
            i += 1
    return out


# Reference flag spellings rewritten to their canonical equivalents
# (reference: include/io/CliParser.hpp:11-145 — the reference accepts many
# spellings per option; a reference user's command line should just work).
# Value-taking aliases keep the following token as the value.
_ALIASES: dict[str, list[str]] = {
    "-help": ["-h"], "--help": ["-h"],
    "-version": ["-v"], "--version": ["-v"],
    # P-1 variants
    "-pm1-lowmem": ["-lowmem"], "-pm1lowmem": ["-lowmem"],
    "--pm1-lowmem": ["-lowmem"],
    "-pm1-ultralowmem": ["-ultralowmem"],
    "-pm1ultralowmem": ["-ultralowmem"],
    "--pm1-ultralowmem": ["-ultralowmem"],
    "-pm1-1reg": ["-ultralowmem"],
    # 2-register stage-2-only resume (reference: CliParser.cpp:613-621 —
    # implies ultralowmem and auto-locates resume_p<p>_B1_<b1>.p95/.save)
    "-pm1-s2-resume2reg": ["-ultralowmem", "-s2resume"],
    "--pm1-s2-resume2reg": ["-ultralowmem", "-s2resume"],
    "-pm1s2resume2reg": ["-ultralowmem", "-s2resume"],
    "-pm1-stage2-2reg": ["-ultralowmem", "-s2resume"],
    "-pm1-stage2-classic": ["-s2variant", "classic"],
    "-pm1-stage2-vtrace": ["-s2variant", "vtrace"],
    "-pm1-vtrace": ["-s2variant", "vtrace"],
    "--pm1-vtrace": ["-s2variant", "vtrace"],
    "-vtrace": ["-s2variant", "vtrace"],
    "-vtrace-off": ["-s2variant", "classic"],
    "-pm1-vtrace-off": ["-s2variant", "classic"],
    "--pm1-vtrace-off": ["-s2variant", "classic"],
    "-vtrace-d": ["-d"], "-pm1-vtrace-d": ["-d"],
    "--pm1-vtrace-d": ["-d"],
    "-vtrace-max-regs": ["-s2regs"], "-pm1-vtrace-max-regs": ["-s2regs"],
    "--pm1-vtrace-max-regs": ["-s2regs"],
    "-b2start": ["-b2start"], "--b2start": ["-b2start"],
    "-s2from": ["-b2start"], "--s2from": ["-b2start"],
    "-stage2start": ["-b2start"], "--stage2start": ["-b2start"],
    "-nogcd-stage1": ["-nogcdstage1"], "--nogcd-stage1": ["-nogcdstage1"],
    "-no-gcd-stage1": ["-nogcdstage1"],
    # ECM curve families / options
    "-torsion8": ["-torsion", "8"],
    "-torsion16": ["-torsion", "16"],
    "-iv163": ["-torsion", "163"],
    "-notorsion": ["-torsion", "0"],
    "-cmont": ["-montgomery"],
    "-seed": ["-curve-seed"],
    "-ecm-continue-after-factor": ["-continue-after-factor"],
    "-f": ["-save-dir"],   # reference: -f <path> = checkpoint directory
    "--ecm-continue-after-factor": ["-continue-after-factor"],
    "-ecm-continue-curves-after-factor": ["-continue-after-factor"],
    # Aevum PFA plan forcing -> the second arithmetic path (this
    # framework's analog of the Aevum 3/9-smooth PFA plans is the
    # GF(M31^2)xGF(M61^2) NTT whose shape family is 3*2^k/9*2^k;
    # reference: CliParser.cpp:277-330, README.md:901-948)
    "-pfa3": ["-arith", "fft3161"],
    "-pfa9": ["-arith", "fft3161"],
    "-pfa=3": ["-arith", "fft3161"],
    "-pfa=9": ["-arith", "fft3161"],
    "-pfa=auto": ["-arith", "auto"],
    "-pfa": ["-arith", "auto"],
    "-pfa-auto": ["-arith", "auto"],
    "-pfa-off": ["-arith", "gl64"],
    "-no-pfa": ["-arith", "gl64"],
    "-pfa9-type4": ["-arith", "fft3161"],
    "-pfa9-type4-fast": ["-arith", "fft3161"],
    "-pfa9-type4-full": ["-arith", "fft3161"],
    "-pfa9-fft323161": ["-arith", "fft3161"],
    # modes
    "-llunsafe": ["-ll"],
    "-llsafecpu": ["-llsafe"],
    "--noask": ["-noask"],
}

# Accepted for reference compatibility; semantically a no-op here (the
# behavior is the default, or the knob is OpenCL/network-specific).
# Value = True when the flag consumes one argument.
_NOOP_FLAGS: dict[str, bool] = {
    "-gerbiczli": False,          # default on (disable: -nogerbiczli)
    "-proof": False,              # default on (disable: -noproof)
    "-noverify": False,           # proof verify is opt-in already
    "-debug": False,
    "-edwards": False,            # default curve family
    "-ced": False,
    "-brent": False,
    "-bsgs": False,               # stage 2 is BSGS already
    "-pm1-continue-after-factor": False,     # default behavior: stage 2
    "--pm1-continue-after-factor": False,    # runs after a S1 factor
    "-pm1-continue-stage2-after-factor": False,
    "--pm1-continue-stage2-after-factor": False,
    "-vtrace-pair95": False, "-pm1-vtrace-pair95": False,
    "--pm1-vtrace-pair95": False,            # pairing is default-on
    "-vtrace-pair95-off": False, "-pm1-vtrace-pair95-off": False,
    "--pm1-vtrace-pair95-off": False,
    "-vtrace-pair95-l": True, "-pm1-vtrace-pair95-l": True,
    "--pm1-vtrace-pair95-l": True,
    "-vtrace-product-tree": False, "-pm1-vtrace-product-tree": False,
    "--pm1-vtrace-product-tree": False,      # accumulation is default-on
    "-vtrace-product-tree-width": True,
    "-pm1-vtrace-product-tree-width": True,
    "--pm1-vtrace-product-tree-width": True,
    "-vtrace-auto-d": False, "-pm1-vtrace-auto-d": False,
    "--pm1-vtrace-auto-d": False,            # auto-D is default-on
    "-vtrace-auto-d-aggressive": False,
    "-pm1-vtrace-auto-d-aggressive": False,
    "--pm1-vtrace-auto-d-aggressive": False,
    "-vtrace-deep-d": False, "-pm1-vtrace-deep-d": False,
    "--pm1-vtrace-deep-d": False,
    "-vtrace-auto-batch": False, "-pm1-vtrace-auto-batch": False,
    "--pm1-vtrace-auto-batch": False,
    "-vtrace-no-auto-batch": False, "-pm1-vtrace-no-auto-batch": False,
    "--pm1-vtrace-no-auto-batch": False,
    "-vtrace-baby-batch": True, "-pm1-vtrace-baby-batch": True,
    "--pm1-vtrace-baby-batch": True,
    "-vtrace-max-batches": True, "-pm1-vtrace-max-batches": True,
    "--pm1-vtrace-max-batches": True,
    "-vtrace-negadd-off": False, "-pm1-vtrace-negadd-off": False,
    "--pm1-vtrace-negadd-off": False,
    "-nogcd-stage1-classic": False,
    # OpenCL / device knobs with no TPU meaning
    "-kernelpath": True, "-enqueue_max": True, "-chunk256": False,
    "-l1": True, "-l2": True, "-l3": True, "-l5": True,
    "-tbits": True, "-throttle_low": True,
    "-iterforce": True, "-iterforce2": True, "-ecm_progress_ms": True,
    "-c": True,
    "-marin": False, "-engine-marin": False, "-backend-marin": False,
    "-backend-auto": False, "-aevum": False, "-aevum-auto": False,
    # network submission (no egress in this environment; the PrimeNet
    # payload is still written to the results file)
    "-submit": False,
    "-p95": False,
    # experimental reference modes not carried over (SLn torus, s3/s4)
    "-torus": False, "-s3": False, "-s4": False, "-b3": True, "-b4": True,
}


def _rewrite_aliases(argv: list[str]) -> tuple[list[str], list[str]]:
    """Apply _ALIASES / swallow _NOOP_FLAGS; returns (argv, notes)."""
    out: list[str] = []
    notes: list[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in _ALIASES:
            out.extend(_ALIASES[tok])
            i += 1
        elif tok == "-aevum-fft":
            # a forced Aevum plan spec: the analog here is forcing the
            # second arithmetic path; the spec string itself is
            # Aevum-kernel-specific and ignored
            out.extend(["-arith", "fft3161"])
            notes.append("-aevum-fft: plan spec ignored; forcing the "
                         "fft3161 arithmetic path")
            i += 2 if i + 1 < len(argv) else 1
        elif tok in _NOOP_FLAGS:
            takes = _NOOP_FLAGS[tok]
            notes.append(f"{tok}: accepted for reference compatibility "
                         f"(no-op on this backend)")
            i += 2 if takes and i + 1 < len(argv) else 1
        else:
            out.append(tok)
            i += 1
    return out, notes


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="prmers",
        description="TPU-native Mersenne arithmetic: PRP / LL / P-1 / ECM "
                    "with Gerbicz-Li error checking and GIMPS proofs")
    ap.add_argument("exponent", nargs="?", type=int, default=0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("-prp", action="store_true", help="PRP test (default)")
    mode.add_argument("-ll", action="store_true", help="Lucas-Lehmer (unsafe)")
    mode.add_argument("-llsafe", action="store_true",
                      help="LL with sqrt(3)-pair error checking")
    mode.add_argument("-llsafe2", action="store_true",
                      help="LL with block-replay error checking")
    ap.add_argument("-llsafeb", type=int, default=0,
                    help="llsafe2 replay block size (default sqrt(p))")
    mode.add_argument("-pm1", action="store_true", help="P-1 factoring")
    mode.add_argument("-ecm", action="store_true", help="ECM factoring")
    ap.add_argument("-s2variant", dest="stage2_variant", default="vtrace",
                    choices=["vtrace", "classic", "nk"],
                    help="P-1 stage 2 algorithm (nk = the n^K pairwise-"
                         "difference variant, with -nmax and -K)")
    ap.add_argument("-nmax", type=int, default=0,
                    help="n^K stage 2: build H^(m^K) for m = 1..nmax")
    ap.add_argument("-lowmem", action="store_true",
                    help="P-1 with 3 registers: no GL buffers, stage 2 as "
                         "a streamed H^Q product-exponent (no baby table)")
    ap.add_argument("-ultralowmem", action="store_true",
                    help="P-1 with 1-2 registers (H^Q two-register stage "
                         "2; base-3 recompute variant with one)")
    ap.add_argument("-s2regs", dest="stage2_regs_cap", type=int, default=0,
                    help="V-trace register budget (memory cap)")
    ap.add_argument("-resume", dest="auto_resume_export",
                    action="store_true",
                    help="write resume_p<p>_B1_<b1>.save (GMP-ECM) and "
                         ".p95 (Prime95) files after P-1 stage 1 "
                         "(reference -resume)")
    ap.add_argument("-resume_save", default="",
                    help="write a GMP-ECM P-1 resume file after stage 1")
    ap.add_argument("-p95_save", default="",
                    help="write a Prime95 stage-1 save after stage 1")
    ap.add_argument("-resume_load", default="",
                    help="import a stage-1 X from a GMP-ECM or Prime95 file")
    ap.add_argument("-filemers", default="",
                    help="convert a PrMers <p>pm<B1>.mers checkpoint to "
                         "a GMP-ECM .save resume file and exit")
    ap.add_argument("-s2resume", dest="s2_resume", action="store_true",
                    help="stage-2-only run from an auto-located "
                         "resume_p<p>_B1_<b1>.p95/.save stage-1 file "
                         "(the -pm1-s2-resume2reg behavior)")
    ap.add_argument("-p95path", dest="p95_path", default="",
                    help="Prime95/mprime directory: run stage 2 there "
                         "(reference: -p95path, RunPM1.cpp:5947)")
    ap.add_argument("-nop95stage2", dest="p95_stage2",
                    action="store_false",
                    help="disable the external Prime95 stage 2")
    ap.add_argument("-ecm_check_interval", type=int, default=0,
                    help="Edwards invariant-check cadence in group ops")
    mode.add_argument("-bench", action="store_true", help="benchmark mode")
    mode.add_argument("-memtest", action="store_true",
                      help="device determinism / memory test")
    mode.add_argument("-tune", action="store_true",
                      help="measure iter/s per transform size and persist")
    ap.add_argument("-wagstaff", action="store_true",
                    help="Wagstaff PRP (exponent = 2q)")

    ap.add_argument("-backend", default="auto",
                    choices=["auto", "pallas", "jax", "numpy", "sharded"])
    ap.add_argument("-arith", default="auto",
                    choices=["auto", "gl64", "fft3161"],
                    help="arithmetic path: Goldilocks (gl64) or the "
                         "paired GF(M31^2)xGF(M61^2) NTT (fft3161)")
    ap.add_argument("-fft", dest="fft_spec", default="",
                    help="forced transform size (e.g. 8M)")

    ap.add_argument("-v", action="version",
                    version="prmers_tpu (PrMers-compatible TPU framework)")
    ap.add_argument("-b1", type=int, default=0)
    ap.add_argument("-b1old", dest="b1_old", type=int, default=0,
                    help="extend P-1 stage 1 from the previous run's "
                         "resume_p<p>_B1_<b1old>.save/.p95 file up to "
                         "the new -b1 bound")
    ap.add_argument("-b2", type=int, default=0)
    ap.add_argument("-b2start", dest="b2_start", type=int, default=0,
                    help="stage-2 start bound: primes in "
                         "(max(B1, b2start), B2] (-s2from/-stage2start)")
    ap.add_argument("-nogcdstage1", dest="no_gcd_stage1",
                    action="store_true",
                    help="skip the stage-1 gcd; the stage-2 gcd covers "
                         "both stages")
    ap.add_argument("-memlim", type=int, default=0,
                    help="device memory budget in MiB (caps the register "
                         "slot count; excess pages to host)")
    ap.add_argument("-continue-after-factor", dest="continue_after_factor",
                    action="store_true",
                    help="ECM: keep running the remaining curves after a "
                         "factor is found")
    ap.add_argument("-maxe", dest="max_e_bits", type=int, default=0)
    ap.add_argument("-d", dest="stage2_d", type=int, default=0,
                    help="stage-2 giant step D")
    ap.add_argument("-curves", "-K", dest="curves", type=int, default=1)
    ap.add_argument("-sigma", default="")
    ap.add_argument("-curve-seed", dest="curve_seed", type=int, default=0)
    ap.add_argument("-torsion", type=int, default=8,
                    help="ECM curve family: 0 = Suyama/generic, 8 = "
                         "Montgomery torsion-8 (default), 16 = "
                         "torsion-16, 163 = Edwards IV-163 family")
    ap.add_argument("-montgomery", action="store_true",
                    help="ECM Montgomery/Suyama curves instead of the "
                         "default twisted Edwards")

    ap.add_argument("-factors", default="",
                    help="comma-separated known factors (cofactor PRP)")

    ap.add_argument("-nogerbiczli", action="store_true")
    ap.add_argument("-checklevel", type=int, default=0)
    ap.add_argument("-erroriter", type=int, default=0)

    ap.add_argument("-t", dest="backup_interval", type=float, default=300.0)
    ap.add_argument("-save-dir", dest="save_dir", default=".")

    ap.add_argument("-noproof", action="store_true")
    ap.add_argument("-proofpower", dest="proof_power", type=int, default=0)
    ap.add_argument("-proofverify", action="store_true")

    ap.add_argument("-worktodo", dest="worktodo_path", default="worktodo.txt")
    ap.add_argument("-results", dest="results_path", default="results.txt")
    ap.add_argument("-user", default="")
    ap.add_argument("-password", default="",
                    help="PrimeNet password (kept for the submission "
                         "payload; never logged)")
    ap.add_argument("-computer", default="")
    ap.add_argument("-aid", default="")

    ap.add_argument("-gui", action="store_true", help="start the web GUI")
    ap.add_argument("-gui-port", "-http", dest="gui_port", type=int,
                    default=3131,
                    help="GUI HTTP port (reference -http <port>)")
    ap.add_argument("-host", dest="gui_host", default="127.0.0.1",
                    help="GUI bind host (reference -host; 0.0.0.0 "
                         "exposes all interfaces)")
    ap.add_argument("-ipv4", dest="gui_all_ifaces", action="store_true",
                    help="bind the GUI on all IPv4 interfaces")
    ap.add_argument("-res64_display_interval", type=int, default=0)
    ap.add_argument("-profile", action="store_true")
    ap.add_argument("-q", "-quiet", dest="quiet", action="store_true")
    ap.add_argument("-iters", dest="bench_iters", type=int, default=0)
    ap.add_argument("-noask", action="store_true",
                    help="accepted for reference compatibility (no-op)")
    return ap


def parse_args(argv: list[str] | None = None) -> Options:
    argv = _expand_config(list(sys.argv[1:] if argv is None else argv))
    argv, notes = _rewrite_aliases(argv)
    ns = build_parser().parse_args(argv)
    for note in notes:
        print(f"[cli] {note}", file=sys.stderr)
    if ns.memlim:
        import os
        os.environ["PRMERS_MEMLIM_MB"] = str(ns.memlim)
    mode = ("ll" if ns.ll else "llsafe2" if ns.llsafe2 else
            "llsafe" if ns.llsafe else
            "pm1" if ns.pm1 else "ecm" if ns.ecm else
            "bench" if ns.bench else "memtest" if ns.memtest else
            "tune" if ns.tune else "prp")
    factors = tuple(f.strip() for f in ns.factors.split(",") if f.strip())
    return Options(
        exponent=ns.exponent, mode=mode, wagstaff=ns.wagstaff,
        backend=ns.backend, fft_spec=ns.fft_spec, arith=ns.arith,
        gerbiczli=not ns.nogerbiczli, checklevel=ns.checklevel,
        erroriter=ns.erroriter, backup_interval=ns.backup_interval,
        save_dir=ns.save_dir, proof=not ns.noproof,
        proof_power=ns.proof_power, proof_verify=ns.proofverify,
        b1=ns.b1, b1_old=ns.b1_old, b2=ns.b2, b2_start=ns.b2_start,
        no_gcd_stage1=ns.no_gcd_stage1,
        continue_after_factor=ns.continue_after_factor,
        max_e_bits=ns.max_e_bits,
        pm1_variant=("ultralowmem" if ns.ultralowmem else
                     "lowmem" if ns.lowmem else "auto"),
        stage2_d=ns.stage2_d, curves=ns.curves, curve_seed=ns.curve_seed,
        sigma=ns.sigma, torsion=ns.torsion, edwards=not ns.montgomery,
        known_factors=factors, worktodo_path=ns.worktodo_path,
        results_path=ns.results_path, aid=ns.aid, user=ns.user,
        computer=ns.computer, ecm_check_interval=ns.ecm_check_interval,
        llsafe_block=ns.llsafeb, stage2_variant=ns.stage2_variant,
        stage2_regs_cap=ns.stage2_regs_cap,
        nmax=ns.nmax, k_nk=ns.curves,
        resume_save=ns.resume_save, p95_save=ns.p95_save,
        resume_load=ns.resume_load, s2_resume=ns.s2_resume,
        filemers=ns.filemers,
        password=ns.password, auto_resume_export=ns.auto_resume_export,
        p95_path=ns.p95_path, p95_stage2=ns.p95_stage2,
        res64_display_interval=ns.res64_display_interval,
        profile=ns.profile, verbose=not ns.quiet, gui=ns.gui,
        gui_port=ns.gui_port, bench_iters=ns.bench_iters,
        gui_host=("0.0.0.0" if ns.gui_all_ifaces else ns.gui_host),
    )
