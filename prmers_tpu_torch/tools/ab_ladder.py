"""A/B ladder: PRP iter/s for each pipeline variant, one child process
each (the switches are read when the engine is made), and the one-rank
mesh against the single engine.

Twin of the JAX package's tools/ab_ladder.py, with
tools/mesh_engine_device_check.py as its --mesh mode. Usage:

    python -m prmers_tpu_torch.tools.ab_ladder [p] [combo ...]
    python -m prmers_tpu_torch.tools.ab_ladder --mesh [log2n ...]

A combo is comma-joined env assignments. The default combos are the
switches the port's factory reads (engine/factory.py: pipeline_from_env,
PRMERS_NO_PALLAS, PRMERS_ARITH, PRMERS_BACKEND): the row carry (none set),
PRMERS_NO_ROWCARRY=1 (the block carry), PRMERS_XLA_CARRY=1 with and
without PRMERS_NO_ROWCARRY=1 (the hybrid), PRMERS_NO_CHAIN=1,
PRMERS_NO_PALLAS=1 (the any-size engine), PRMERS_ARITH=fft3161,
PRMERS_BACKEND=sharded (MeshEngine on a group of one rank), and
PRMERS_NO_MXU=1, which the factory refuses.

Changes from the JAX tool:
  * A PRMERS_* name the port does not read (port_switches: the names its
    sources read from the environment) is rejected before any child
    starts: the JAX defaults PRMERS_BYTECAST and PRMERS_LHS_BITCAST are TPU
    switches, and passed through they would time the default path under
    a variant's name. The names the factory refuses (PRMERS_NO_MXU,
    PRMERS_NO_WFOLD, PRMERS_NO_FUSE) run, and their row reads REFUSED
    with the factory's NotImplementedError; the ladder goes on.
  * The child has no _SEQ_CHUNK: it times square_mul_seq calls of AB_K
    squarings (AB_ITERS in all, after one warm call), and ends each timing
    in torch.cuda.synchronize(). It also prints the low 64 bits of its
    register, and the rows must agree: every variant runs the same
    squarings of 3.
  * --mesh: at each log2 n (19, 21, 23 by default) and p = int(n * 16.25)
    | 1, MeshEngine on one rank and FourStepEngine run the same ops (a
    chain with a x3, a multiplicand and a mul by 5), and both must equal
    big-int; then their iter/s over iters squarings (128) each. The JAX
    tool exits 1 when the mesh is more than 10% slower; here the rate is
    reported, and only a value that differs fails: where the single
    engine runs the whole-chain kernel K9 (n <= 2^19) and the mesh the
    three-kernel step, a 10% rule would hold no fault.
  * Runs on the card, or on the CPU under PRMERS_PLATFORM=cpu (the child
    inherits it); ends with one JSON line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

from . import device_name, tool_device

P_DEFAULT = 136279841
MESH_LOG2N = (19, 21, 23)
MESH_ITERS = 128

_CHILD = r"""
import os, sys, time
sys.path.insert(0, __ROOT__)
from prmers_tpu_torch.engine.factory import create_engine

dev = "cpu" if os.environ.get("PRMERS_PLATFORM") == "cpu" else None
p = __P__
K = int(os.environ.get("AB_K", "64"))
eng = create_engine(p, 2, device=dev)
eng.set(0, 3)
eng.square_mul_seq(0, [1] * K)   # warm at the timed length
eng.sync()                       # torch.cuda.synchronize() on the card
t0 = time.perf_counter()
rounds = max(int(os.environ.get("AB_ITERS", "192")) // K, 1)
for _ in range(rounds):
    eng.square_mul_seq(0, [1] * K)
eng.sync()
dt = time.perf_counter() - t0
res64 = eng.get_int(0) & 0xFFFFFFFFFFFFFFFF
print(f"AB_RESULT {rounds * K / dt:.2f} {type(eng).__name__} {res64:016X}")
"""

DEFAULT_COMBOS = [
    "",                                 # the row carry
    "PRMERS_NO_ROWCARRY=1",
    "PRMERS_XLA_CARRY=1",
    "PRMERS_NO_ROWCARRY=1,PRMERS_XLA_CARRY=1",
    "PRMERS_NO_CHAIN=1",
    "PRMERS_NO_PALLAS=1",
    "PRMERS_ARITH=fft3161",
    "PRMERS_BACKEND=sharded",
    "PRMERS_NO_MXU=1",
]


def port_switches() -> set:
    """The PRMERS_* names the port reads from the environment, from its
    sources (os.environ.get("..."), os.environ["..."], env.get("...")),
    and the ones the factory refuses."""
    from ..engine.factory import UNPORTED_SWITCHES
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(r"""(?:environ|env)(?:\.get\(|\[)\s*["'](PRMERS_\w+)""")
    names = set(UNPORTED_SWITCHES)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    names.update(pat.findall(fh.read()))
    return names


def combo_env(combo: str) -> dict:
    """The assignments of a combo."""
    env = {}
    for kv in combo.split(","):
        if kv:
            k, _, v = kv.partition("=")
            env[k] = v
    return env


def check_combos(combos) -> None:
    """Raise ValueError for any PRMERS_* name the port does not read."""
    known = port_switches()
    bad = sorted({k for c in combos for k in combo_env(c)
                  if k.startswith("PRMERS_") and k not in known})
    if bad:
        raise ValueError(
            f"the port reads none of {', '.join(bad)}: a variant under "
            "such a name would time the default path (TPU switches such as "
            "PRMERS_BYTECAST have no counterpart here)")


def run_combo(p: int, combo: str, timeout_s: int = 3000):
    """(iter/s or None, engine class or the failure, res64 or None)."""
    env = dict(os.environ)
    env.update(combo_env(combo))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    code = _CHILD.replace("__ROOT__", repr(root)).replace("__P__", str(p))
    try:
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           timeout=timeout_s, capture_output=True,
                           text=True)
    except subprocess.TimeoutExpired:
        return None, "TIMEOUT", None
    for line in r.stdout.splitlines():
        if line.startswith("AB_RESULT"):
            _, ips, engine, res64 = line.split()
            return float(ips), engine, res64
    tail = (r.stderr or r.stdout).strip().splitlines()
    last = tail[-1][:160] if tail else f"rc={r.returncode}"
    if "NotImplementedError" in last:
        return None, "REFUSED: " + last, None
    return None, last, None


def ladder(p: int, combos) -> list[dict]:
    """One row a combo; the rows' res64 must agree."""
    check_combos(combos)
    rows = []
    base = None
    for combo in combos:
        ips, detail, res64 = run_combo(p, combo)
        label = combo or "(row carry)"
        rows.append({"combo": combo, "ips": ips, "engine": detail,
                     "res64": res64})
        if ips is None:
            failed = "" if detail.startswith("REFUSED") else "FAILED: "
            print(f"{label:55s} {failed}{detail}", flush=True)
            continue
        if base is None:
            base = ips
        rows[-1]["pct_of_first"] = ips / base * 100
        print(f"{label:55s} {ips:8.1f} iter/s  "
              f"({ips / base * 100:5.1f}% of first) [{detail} {res64}]",
              flush=True)
    return rows


def ladder_ok(rows) -> bool:
    """Every row ran or was refused, and the ones that ran agree."""
    ran = {r["res64"] for r in rows if r["ips"] is not None}
    return len(ran) <= 1 and all(
        r["ips"] is not None or r["engine"].startswith("REFUSED")
        for r in rows)


def _rate(eng, iters: int) -> float:
    eng.set(0, 3)
    eng.square_mul_seq(0, [1] * iters)   # warm: same chain length
    eng.sync()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * iters)
    eng.sync()
    return iters / (time.perf_counter() - t0)


def mesh_check(log2n: int, iters: int, device) -> dict:
    """MeshEngine on one rank against FourStepEngine and big-int at
    n = 2^log2n (tools/mesh_engine_device_check.py)."""
    from ..core.plan import build_plan
    from ..engine.fourstep_engine import FourStepEngine
    from ..parallel.mesh_engine import MeshEngine
    n = 1 << log2n
    p = int(n * 16.25) | 1
    mp = (1 << p) - 1
    t0 = time.perf_counter()
    me = MeshEngine(p, 2, device=device, n=n)
    mesh_s = time.perf_counter() - t0
    pe = FourStepEngine(p, 2, plan=build_plan(p, n=n), device=device)
    for eng in (me, pe):
        eng.set(0, 3)
        eng.square_mul_seq(0, [1, 1, 3, 1])
        eng.set(1, 7)
        eng.set_multiplicand(1, 1)
        eng.mul(0, 1, 5)
    want = 3
    for a in (1, 1, 3, 1):
        want = want * want * a % mp
    want = want * 7 * 5 % mp
    vm, vp = me.get_int(0), pe.get_int(0)
    rm, rp = _rate(me, iters), _rate(pe, iters)
    return {"log2n": log2n, "p": p, "n": n, "mesh_tables_s": mesh_s,
            "mesh_bigint": vm == want, "single_bigint": vp == want,
            "bitexact": vm == vp == want, "single_ips": rp,
            "mesh_ips": rm, "ratio": rm / rp,
            "within_10pct": rm >= 0.90 * rp}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = tool_device()
    card = device_name(dev)
    if argv[:1] == ["--mesh"]:
        rows = []
        for log2n in [int(a) for a in argv[1:]] or MESH_LOG2N:
            r = mesh_check(log2n, MESH_ITERS, dev)
            rows.append(r)
            print(f"2^{log2n} p={r['p']}: bit-exact "
                  f"{'OK' if r['bitexact'] else 'FAILED'}; FourStepEngine "
                  f"{r['single_ips']:9.2f} iter/s, MeshEngine "
                  f"{r['mesh_ips']:9.2f} iter/s ({r['ratio']:.3f}x); "
                  f"within 10%: {r['within_10pct']}", flush=True)
        ok = all(r["bitexact"] for r in rows)
        print(json.dumps({"tool": "ab_ladder", "mode": "mesh",
                          "card": card, "rows": rows, "ok": ok}))
        return 0 if ok else 1
    p = int(argv[0]) if argv and argv[0].isdigit() else P_DEFAULT
    combos = [a for a in argv if not a.isdigit()] or DEFAULT_COMBOS
    rows = ladder(p, combos)
    ok = ladder_ok(rows)
    print(json.dumps({"tool": "ab_ladder", "p": p, "card": card,
                      "rows": rows, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
