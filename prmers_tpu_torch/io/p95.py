"""External Prime95/mprime stage-2 handoff.

Mirrors the reference's orchestration (reference: p95_run_pm1_stage2_task,
src/modes/RunPM1.cpp:479-633; directory/exe probing :5947-5993; worktodo
line construction :6010-6021): write the stage-1 state as a Prime95 save
file named m%07d in the Prime95 directory, drop a one-line worktodo.txt,
run the executable with -d, then parse the last line of results.json.txt
(JSON with "status" NF/F and an optional factor).

The subprocess is the external Prime95 binary the USER points at with
-p95path; nothing here depends on it being present (the handoff is
skipped with a log line when the directory or executable is missing,
exactly like the reference).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess

from . import interop

EXE_CANDIDATES = ("mprime", "prime95", "prime95.exe", "mprime.exe")


@dataclasses.dataclass
class P95Result:
    success: bool = False
    factor: int = 0
    known_factor: bool = False
    status: str = ""
    json_line: str = ""
    exit_code: int = 0
    error: str = ""


def find_exe(p95_dir: str) -> str:
    """Absolute path of the Prime95/mprime executable in p95_dir, or ""
    (reference: exe candidate probing, RunPM1.cpp:5960-5973)."""
    d = os.path.expanduser(p95_dir)
    if not os.path.isdir(d):
        return ""
    for cand in EXE_CANDIDATES:
        path = os.path.join(d, cand)
        if os.path.exists(path):
            return os.path.abspath(path)
    return ""


def pm1_worktodo_line(p: int, b1: int, b2: int, b2_start: int = 0,
                      known_factors: tuple = ()) -> str:
    """Prime95 worktodo entry for a Mersenne P-1 stage-2 continuation
    (reference: RunPM1.cpp:6010-6021)."""
    line = f"Pminus1=1,2,{p},-1,{b1},{b2}"
    if b2_start > 0:
        line += f",0,{b2_start}"
    if known_factors:
        line += ',"' + ",".join(str(f) for f in known_factors) + '"'
    return line


def parse_results_line(line: str) -> tuple[str, int]:
    """(status, factor) from a results.json.txt line (reference:
    p95_parse_result_json_line, RunPM1.cpp:469-477)."""
    try:
        obj = json.loads(line)
    except ValueError:
        return "", 0
    status = str(obj.get("status", ""))
    factor = 0
    factors = obj.get("factors")
    if isinstance(factors, (list, tuple)) and factors:
        factor = int(str(factors[0]))
    elif obj.get("factor"):
        factor = int(str(obj["factor"]))
    return status, factor


def ecm_worktodo_line(p: int, b2: int, resume_filename: str,
                      known_factors: tuple = ()) -> str:
    """Prime95 worktodo entry for an ECM stage-2 continuation from a
    GMP-ECM resume file (reference: p95_enqueue_curve,
    RunEcmTwistedEdwards.cpp:1170)."""
    line = f'ECMSTAGE2=N/A,1,2,{p},-1,"{resume_filename}",{b2}'
    if known_factors:
        line += ',"' + ",".join(str(f) for f in known_factors) + '"'
    return line


def _run_and_parse(d: str, exe: str, line: str, log_path: str,
                   known_factors: tuple, log,
                   timeout: float | None) -> P95Result:
    """Shared tail: write worktodo, run exe -d, parse results.json.txt."""
    r = P95Result()
    results_file = os.path.join(d, "results.json.txt")
    for stale in ("worktodo.txt", "results.json.txt"):
        try:
            os.remove(os.path.join(d, stale))
        except OSError:
            pass
    with open(os.path.join(d, "worktodo.txt"), "w") as f:
        f.write(line + "\n")
    try:
        with open(log_path, "w") as lf:
            proc = subprocess.run([exe, "-d"], cwd=d, stdout=lf,
                                  stderr=subprocess.STDOUT,
                                  timeout=timeout)
        r.exit_code = proc.returncode
    except (OSError, subprocess.TimeoutExpired) as e:
        r.error = f"Prime95 run failed: {e}"
        return r
    try:
        with open(results_file) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        r.json_line = lines[-1] if lines else ""
    except OSError:
        r.json_line = ""
    if not r.json_line:
        r.error = (f"Prime95 did not produce results.json.txt "
                   f"(exit_code={r.exit_code}) | worktodo={line}")
        return r
    status, factor = parse_results_line(r.json_line)
    if not status:
        r.error = "unable to parse Prime95 results.json.txt line"
        return r
    r.status = status
    r.factor = factor
    known = {int(k) for k in known_factors}
    r.known_factor = factor != 0 and factor in known
    r.success = status in ("NF", "F")
    if not r.success:
        r.error = f"Prime95 returned an unsupported status: {status}"
    return r


def run_ecm_stage2(p95_dir: str, p: int, b2: int, resume_src: str,
                   curve_idx: int = 0, known_factors: tuple = (),
                   log=print, timeout: float | None = None) -> P95Result:
    """Hand one curve's GMP-ECM stage-1 resume file to an external
    Prime95 for ECM stage 2 (reference queues curves to a background
    worker, RunEcmTwistedEdwards.cpp:1136-1199; here the handoff runs
    synchronously per curve)."""
    r = P95Result()
    d = os.path.expanduser(p95_dir)
    exe = find_exe(d)
    if not exe:
        r.error = f"no Prime95/mprime executable in '{p95_dir}'"
        return r
    fname = os.path.basename(resume_src)
    dst = os.path.join(d, fname)
    try:
        if os.path.abspath(resume_src) != os.path.abspath(dst):
            with open(resume_src, "rb") as fi, open(dst, "wb") as fo:
                fo.write(fi.read())
    except OSError as e:
        r.error = f"could not stage resume file: {e}"
        return r
    line = ecm_worktodo_line(p, b2, fname, known_factors)
    log_path = os.path.join(
        d, f"prmers_p95stage2_curve_{curve_idx + 1:06d}.log")
    log(f"[ECM] Prime95 Stage2 start | resume={fname} | log={log_path}")
    return _run_and_parse(d, exe, line, log_path, known_factors, log,
                          timeout)


def run_pm1_stage2(p95_dir: str, p: int, b1: int, b2: int, x1: int,
                   b2_start: int = 0, known_factors: tuple = (),
                   log=print, timeout: float | None = None) -> P95Result:
    """Hand the residue x1 = 3^(E*2p) to an external Prime95 for stage 2.

    Writes the state file (m%07d), worktodo.txt, runs `exe -d` in the
    Prime95 directory, and parses results.json.txt. Returns a P95Result;
    r.error is set (and success False) on any orchestration failure so
    the caller can fall back to the internal stage 2."""
    r = P95Result()
    d = os.path.expanduser(p95_dir)
    exe = find_exe(d)
    if not exe:
        r.error = f"no Prime95/mprime executable in '{p95_dir}'"
        return r

    state = os.path.join(d, f"m{p:07d}")
    try:
        interop.write_prime95_s1(state, p, b1, x1)
    except OSError as e:
        r.error = f"could not write state file {state}: {e}"
        return r

    line = pm1_worktodo_line(p, b1, b2, b2_start, known_factors)
    log_path = os.path.join(d, f"prmers_p95stage2_pm1_p{p}.log")
    log(f"[PM1] Prime95 Stage2 start | state={state} | log={log_path}")
    return _run_and_parse(d, exe, line, log_path, known_factors, log,
                          timeout)
