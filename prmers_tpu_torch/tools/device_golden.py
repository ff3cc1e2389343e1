"""On-device golden ladder: every BASELINE.md correctness row run on the
card, with the Gerbicz-Li error injection and a kill/resume mid-run.

Twin of the JAX package's tools/device_golden.py (reference analog:
unit_tests.sh run on real hardware per release, unit_tests.sh:5-235): it
proves the production path end to end, the kernels, the card's memory,
checkpoint files on disk, a process killed and resumed. Usage:

    python -m prmers_tpu_torch.tools.device_golden [quick|full] [round_tag]

  quick:  every step but MM31's
  full:   + MM31's P-1 (-b1 100 -b2 5000 -pm1-ultralowmem -nogcd-stage1 at
          n = 5 * 2^25, the work of chip_smoke.py --mm31; ~36 min)

Changes from the JAX tool:
  * Each PRP step makes its engine as run_prp_or_ll would (create_engine
    with the options' backend and arithmetic, workload "prp") on the
    tool's device and names it in its detail; the P-1 and ECM steps pass
    the device to run_pm1 and run_ecm_edwards.
  * The kill/resume step runs M44497 (backup every 1.0 s) where the JAX
    step ran M11213 (every 2.0 s), and kills the child when its first
    checkpoint appears: on the card M11213 ends in a few seconds (the
    any-size engine, or fft3161 where tune records pick it), before a
    backup, and the step would report killed_midrun=False. The resumed
    run must log "Resuming from a checkpoint." and reach res64 1.
  * The record goes to build/device_golden/DEVICE_<tag>.md and .json
    under the repository root (tag "h100" by default), never over the
    TPU's DEVICE_r04.* at the root.
  * It runs on the card, or on the CPU under PRMERS_PLATFORM=cpu (the
    kill/resume child inherits it), and ends with one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

from . import device_name, tool_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KILL_P = 44497           # a prime: the resumed run ends at res64 1
KILL_BACKUP_S = 1.0
MM31 = (1 << 31) - 1

GOLDEN_9941 = [
    "proof [0] : M 87f3d3eabe4d6049, h 4526397be82cea45",
    "proof [1] : M d6a355de518574d7, h 7faf92dd48dc2013",
    "proof [2] : M 5aac235405ca84c7, h 934611f5f1192dd0",
]
GOLDEN_11213 = {
    1000: "FBA631FBCB73A011", 2000: "F01283650C4A1491",
    3000: "7E79193B757010B7", 4000: "31482E4D80FE99BB",
    5000: "973B76BACF73BBEF", 6000: "8CFFB332495FC320",
    7000: "98080C76DF068843", 8000: "8FDA516F885D3FEE",
    9000: "2AADBC4F1E318E92", 10000: "0A4AAF339C8B290C",
    11000: "A1F26F470CFE412D",
}

_CHILD = r"""
import os, sys
sys.path.insert(0, __ROOT__)
from prmers_tpu_torch.engine.factory import create_engine
from prmers_tpu_torch.io.options import Options
from prmers_tpu_torch.modes.prp_ll import run_prp_or_ll
p = __P__
dev = "cpu" if os.environ.get("PRMERS_PLATFORM") == "cpu" else None
eng = create_engine(p, 8, device=dev, workload="prp")
r = run_prp_or_ll(Options(exponent=p, mode="prp", proof=False,
                          verbose=False, backup_interval=__BACKUP__,
                          save_dir=__DIR__), eng=eng)
print("ENGINE", type(eng).__name__)
print("RES64", r.res64)
"""


def step(name, results):
    """Run fn as the step `name`, its outcome appended to results."""
    def deco(fn):
        def run(*args):
            t0 = time.time()
            try:
                detail = fn(*args) or ""
                ok = True
            except Exception as e:  # noqa: BLE001 — ladder must continue
                detail = f"{type(e).__name__}: {e}"
                ok = False
            dt = time.time() - t0
            results.append({"step": name, "ok": ok, "secs": round(dt, 1),
                            "detail": str(detail)[:500]})
            print(f"[{'PASS' if ok else 'FAIL'}] {name} ({dt:.1f}s) "
                  f"{detail}", flush=True)
        return run
    return deco


def _opts(**kw):
    from ..io.options import Options
    kw.setdefault("verbose", False)
    kw.setdefault("save_dir", tempfile.mkdtemp(prefix="devgold_"))
    return Options(**kw)


def _prp(opts, device, **kw):
    """run_prp_or_ll on the engine it would make itself, on device:
    (result, engine class)."""
    from ..engine.factory import create_engine
    from ..modes.prp_ll import run_prp_or_ll
    eng = create_engine(opts.exponent, 8, device=device,
                        backend=opts.backend, arith=opts.arith,
                        workload="prp")
    return run_prp_or_ll(opts, eng=eng, **kw), type(eng).__name__


def m127(device):
    r, eng = _prp(_opts(exponent=127, mode="ll", proof=False), device,
                  log=lambda *a: None)
    assert r.is_prime, "M127 must be prime"
    return f"prime [{eng}]"


def m9941_proof(device):
    from ..core.plan import cached_plan
    from ..core.proof import Proof, ProofSet
    cwd = os.getcwd()
    d = tempfile.mkdtemp(prefix="devgold_")
    os.chdir(d)
    try:
        p = 9941
        ps = ProofSet(p, 3, widths=cached_plan(p).widths)
        r, eng = _prp(_opts(exponent=p, mode="prp", save_dir=d), device,
                      proof_set=ps, log=lambda *a: None)
        assert r.is_prime, "M9941 must be PRP"
        lines = []
        proof = ps.compute_proof(log=lines.append)
        assert lines == GOLDEN_9941, f"proof hashes diverge: {lines}"
        path = proof.save()
        assert Proof.load(path).verify(log=lambda *a: None)
        return f"3 golden hashes + verify [{eng}]"
    finally:
        os.chdir(cwd)


def m11213_stream(device):
    logs = []
    r, eng = _prp(_opts(exponent=11213, mode="prp", proof=False,
                        res64_display_interval=1000), device,
                  log=lambda *a: logs.append(" ".join(map(str, a))))
    assert r.is_prime and r.res64 == "0000000000000001"
    seen = {}
    for line in logs:
        if "Res64:" in line and "Iter:" in line:
            it = int(line.split("Iter:")[1].split("|")[0].strip())
            seen[it] = line.split("Res64:")[1].strip()
    for it, want in GOLDEN_11213.items():
        assert seen.get(it) == want, f"iter {it}: {seen.get(it)} != {want}"
    return f"11 golden intermediates + final res64 [{eng}]"


def m100003(device):
    r, eng = _prp(_opts(exponent=100003, mode="prp", proof=False), device,
                  log=lambda *a: None)
    assert not r.is_prime
    assert r.res64 == "1CF45E9503C71FD6", r.res64
    assert r.res2048.lower().endswith("1cf45e9503c71fd6")
    return f"res64={r.res64} [{eng}]"


def erroriter(device):
    logs = []
    r, eng = _prp(_opts(exponent=9941, mode="prp", proof=False,
                        erroriter=55, checklevel=1), device,
                  log=lambda *a: logs.append(" ".join(map(str, a))))
    assert r.is_prime, "recovery must still find M9941 prime"
    joined = "\n".join(logs)
    assert "Injected error" in joined
    assert "Check FAILED" in joined or "Restore" in joined, joined[-500:]
    return (f"injected, detected, recovered, still prime "
            f"(gerbicz_errors={r.gerbicz_errors}) [{eng}]")


def kill_resume(device=None, p: int = KILL_P,
                backup_s: float = KILL_BACKUP_S):
    """The child PRP killed when its first checkpoint appears, then run
    again: it must resume and end at res64 1 (p a Mersenne prime). The
    child takes the tool's device from the environment (the card, or the
    CPU under PRMERS_PLATFORM=cpu); `device` is not read."""
    d = tempfile.mkdtemp(prefix="devgold_")
    prog = _CHILD.replace("__ROOT__", repr(REPO)).replace(
        "__P__", str(p)).replace("__BACKUP__", repr(backup_s)).replace(
        "__DIR__", repr(d))
    pr = subprocess.Popen([sys.executable, "-c", prog],
                          stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
    # wait for the first checkpoint file, then kill mid-run
    deadline = time.time() + 600
    ck = os.path.join(d, f"m_{p}.ckpt")
    while time.time() < deadline and not os.path.exists(ck):
        if pr.poll() is not None:
            break
        time.sleep(0.05)
    killed = pr.poll() is None
    if killed:
        pr.kill()
    pr.wait()
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=1200)
    assert "RES64 0000000000000001" in out.stdout, out.stdout[-500:]
    resumed = "Resuming from a checkpoint." in out.stdout
    assert resumed or not killed, "the resumed run started afresh"
    eng = out.stdout.split("ENGINE ")[1].split()[0]
    return (f"killed_midrun={killed}, resumed={resumed}, to golden res64 "
            f"[{eng}]")


def m367(device):
    from ..modes.pm1 import run_pm1
    r = run_pm1(_opts(exponent=367, mode="pm1", b1=11981, b2=38971),
                log=lambda *a: None, device=device)
    assert r.factor is not None and r.factor % 646300400639 == 0, r.factor
    return f"factor={r.factor}"


def m541(device):
    from ..modes.pm1 import run_pm1
    r = run_pm1(_opts(exponent=541, mode="pm1", b1=899),
                log=lambda *a: None, device=device)
    assert r.factor is not None and r.factor % 4312790327 == 0, r.factor
    return f"factor={r.factor}"


def m701(device):
    from ..modes.ecm_edwards import run_ecm_edwards
    r = run_ecm_edwards(_opts(exponent=701, mode="ecm", b1=6000, b2=33333,
                              curves=8, curve_seed=1),
                        log=lambda *a: None, device=device)
    assert r.factor and ((1 << 701) - 1) % r.factor == 0, r.factor
    return f"factor={r.factor}"


def mm31(device):
    from ..core.plan import cached_plan
    from ..engine.fourstep_engine import covers
    from ..modes.pm1 import run_pm1
    eligible = covers(cached_plan(MM31))
    r = run_pm1(_opts(exponent=MM31, mode="pm1", b1=100, b2=5000,
                      pm1_variant="ultralowmem", no_gcd_stage1=True),
                log=lambda *a: None, device=device)
    assert r.factor is not None and r.factor % 295257526626031 == 0, r.factor
    return f"factor={r.factor}, fourstep_covers={eligible}"


def steps(mode: str, results: list) -> list:
    """The ladder's steps, each wrapped to append to results."""
    named = [
        ("M127 LL prime (unit_tests.sh:5-9)", m127),
        ("M9941 PRP + proof hashes + verify (unit_tests.sh:188-204)",
         m9941_proof),
        ("M11213 res64 stream @1000.. (unit_tests.sh:163-186)",
         m11213_stream),
        ("M100003 PRP res64/res2048 (unit_tests.sh:137-149)", m100003),
        ("GL error injection + recovery (unit_tests.sh:24-59)", erroriter),
        (f"kill/resume mid-run (M{KILL_P}, backup every {KILL_BACKUP_S} s, "
         "SIGKILL at the first checkpoint + resume)", kill_resume),
        ("M367 P-1 S1+S2 factors (unit_tests.sh:60)", m367),
        ("M541 P-1 B1=899 factor (unit_tests.sh:205-213)", m541),
        ("M701 ECM Edwards B1=6000 B2=33333 K=8 (README.md:103-105)", m701),
    ]
    if mode == "full":
        named.append(("MM31 P-1 B1=100 B2=5000 ultralowmem -> "
                      "295257526626031 (README.md:97,636; n=5*2^25)", mm31))
    return [step(name, results)(fn) for name, fn in named]


def write_record(out: dict, tag: str) -> str:
    """DEVICE_<tag>.json and .md under build/device_golden/; the .md's
    path."""
    d = os.path.join(REPO, "build", "device_golden")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"DEVICE_{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    lines = [f"# DEVICE_{tag} — on-device golden ladder",
             "",
             f"Device: {out['device']}  |  {out['timestamp']}  |  "
             f"{out['passed']}/{out['total']} passed "
             f"(reference analog: unit_tests.sh on real hardware)",
             "", "| Step | Result | Time | Detail |", "|---|---|---:|---|"]
    for r in out["steps"]:
        lines.append(f"| {r['step']} | {'PASS' if r['ok'] else 'FAIL'} | "
                     f"{r['secs']}s | {r['detail']} |")
    path = os.path.join(d, f"DEVICE_{tag}.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if len(argv) > 0 else "quick"
    tag = argv[1] if len(argv) > 1 else "h100"
    dev = tool_device()
    card = device_name(dev)
    print(f"device: {card}", flush=True)
    results = []
    for run in steps(mode, results):
        run(dev)
    npass = sum(1 for r in results if r["ok"])
    out = {"tag": tag, "mode": mode,
           "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
           "device": card, "passed": npass, "total": len(results),
           "ok": npass == len(results), "steps": results}
    path = write_record(out, tag)
    print(f"\n{npass}/{len(results)} passed -> {path}", flush=True)
    print(json.dumps({"tool": "device_golden", **out}))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
