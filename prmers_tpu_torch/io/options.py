"""Run options — the flat config record every mode consumes.

Analog of the reference CliOptions (reference: include/io/CliParser.hpp:11-145);
populated by the CLI parser, worktodo entries, and the web GUI.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Options:
    exponent: int = 0
    mode: str = "prp"            # prp | ll | llsafe | llsafe2 | pm1 | ecm | bench | memtest
    wagstaff: bool = False

    # engine / backend
    backend: str = "auto"        # auto | jax | numpy
    device_id: int = 0
    fft_spec: str = ""           # forced transform size spec ("8M", "5*2^25", ...)

    # error checking
    gerbiczli: bool = True
    checklevel: int = 0          # 0 = auto
    erroriter: int = 0           # inject an error at this iteration (testing)

    # checkpoints
    backup_interval: float = 300.0
    save_dir: str = "."

    # proof
    proof: bool = True
    proof_power: int = 0         # 0 = auto (bestPower)
    manual_proof_power: bool = False
    proof_verify: bool = False

    # P-1
    b1: int = 0
    b1_old: int = 0              # -b1old: extend stage 1 from the
                                 # resume_p<p>_B1_<b1old>.save/.p95 file
    b2: int = 0
    b2_start: int = 0            # stage-2 start bound (-b2start/-s2from):
                                 # primes in (max(B1, b2start), B2]
    max_e_bits: int = 0          # stage-1 exponent chunk cap (bits), 0 = auto
    pm1_variant: str = "auto"    # auto | normal | lowmem | ultralowmem
    stage2_d: int = 0            # 0 = auto
    nmax: int = 0
    k_nk: int = 0
    no_gcd_stage1: bool = False  # skip the stage-1 gcd (-nogcd-stage1):
                                 # the stage-2 gcd covers both stages

    # ECM
    curves: int = 1
    continue_after_factor: bool = False  # keep running remaining curves
                                 # after a factor (-ecm-continue-after-factor)
    curve_seed: int = 0
    sigma: str = ""
    torsion: int = 8             # 0 | 8 | 16 | 163 (Edwards IV-163)
    edwards: bool = True
    ecm_check_interval: int = 0
    llsafe_block: int = 0        # llsafe2 replay block size (-llsafeb)
    stage2_variant: str = "vtrace"  # vtrace (default) | classic
    stage2_regs_cap: int = 0     # V-trace register budget (0 = default)
    resume_save: str = ""        # export GMP-ECM P-1 resume line after S1
    auto_resume_export: bool = False  # -resume: write both resume formats
                                 # with the canonical names after stage 1
    p95_save: str = ""           # export Prime95 stage-1 save after S1
    resume_load: str = ""        # import a stage-1 X (either format)
    filemers: str = ""           # -filemers: convert a .mers checkpoint
                                 # to a GMP-ECM .save file and exit
    s2_resume: bool = False      # -pm1-s2-resume2reg: stage 2 only, from
                                 # an auto-located resume_p<p>_B1_<b1>
                                 # .p95/.save file (2-register H^Q)
    p95_path: str = ""           # Prime95 dir for external stage 2
    p95_stage2: bool = True      # -nop95stage2 disables the handoff
    arith: str = "auto"          # auto | gl64 | fft3161 (second NTT path)
    invariant_error_iter: int = 0

    # cofactor PRP
    known_factors: tuple[str, ...] = ()

    # worktodo / results
    worktodo_path: str = "worktodo.txt"
    results_path: str = "results.txt"
    aid: str = ""
    user: str = ""
    password: str = ""           # PrimeNet password (-password; kept for
                                 # the manual-submission payload, never
                                 # logged — no egress in this runtime)
    computer: str = ""

    # observability
    res64_display_interval: int = 0
    profile: bool = False
    verbose: bool = True

    # web gui
    gui: bool = False
    gui_port: int = 3131
    gui_host: str = "127.0.0.1"  # -host (0.0.0.0 exposes all interfaces)

    # bench
    bench_iters: int = 0

    # bookkeeping filled during runs
    gerbicz_error_count: int = 0
