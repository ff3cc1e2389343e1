"""GL-window smoke: run each ladder exponent's PRP until its FIRST
Gerbicz-Li check passes, then stop and move on.

Twin of the JAX package's tools/gl_smoke.py, itself the analog of the
reference's unit_test_all.sh (27 exponents, each killed after the first
"[Gerbicz Li] Check passed" appears in the log): it validates every
transform size's first verified window (the squarings, the multiplicand,
`mul`, `copy` and the compare of the check) without a full run. Usage:

    python -m prmers_tpu_torch.tools.gl_smoke [max_exponent]

Changes from the JAX tool:
  * `smoke_one(p, device=None)` takes the device (None: the card);
    `smoke_row` does its work and also returns the engine class, the
    arithmetic (and the policy's reason where "auto" chose it), n, the
    iteration of the first pass, the seconds of the engine's set-up, of
    the window and of the save after it (the KeyboardInterrupt that stops
    the run makes run_prp_or_ll write its checkpoint, which reads every
    register back: 2 GiB at n = 2^25), and the window's rate: its
    squarings (iter, then the check's replay of B = isqrt(p)) over its
    seconds. run_prp_or_ll prints no progress line before the first check
    (the check ends the first chunk), so there is none to read.
  * The ladder runs in a fresh working directory and prints the tune
    records it read there (none): the policy reads prmers_torch_tune.json
    in the working directory (core/tune.py), and records would send small
    p to fft3161.
  * For p <= 3021377 each exponent runs again under the arithmetic that
    "auto" did not pick: both arithmetics are viable there.
  * After each row the engines' table caches are dropped (the ladder
    builds the tables of 27 plans and more in one process).
  * It runs on the card, or on the CPU under PRMERS_PLATFORM=cpu, and ends
    with one JSON line of the rows.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import sys
import tempfile
import time

from . import device_name, tool_device

# the top of the range where both arithmetics are viable (their rates
# measured on the H100, PERF.md)
BOTH_ARITH_MAX = 3021377


def drop_tables() -> None:
    """Release every engine's cached tables (host and device)."""
    import gc

    import torch

    from ..engine import engine3161, fourstep_engine, torch_engine
    fourstep_engine._HOST_TABLES.clear()
    fourstep_engine._DEV_TABLES.clear()
    torch_engine._TABLES_CACHE.clear()
    engine3161._DEV_TABLES.clear()
    engine3161.host_tables.cache_clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def smoke_row(p: int, device=None, arith: str = "auto") -> dict:
    """One exponent's PRP under the automatic engine choice and `arith`,
    stopped at its first passed Gerbicz-Li check: a dict with ok, seconds,
    detail (as smoke_one) and what ran (see the module docstring)."""
    from .. import torchconf
    from ..core.quickcheck import quick_check
    from ..engine.factory import create_engine
    from ..engine.policy import decide_arith
    from ..io.options import Options
    from ..modes.prp_ll import run_prp_or_ll

    dev = torchconf.device(device)
    seen = {}

    def log(msg, *a, **k):
        m = str(msg)
        if "[Gerbicz Li] Check passed" in m:
            seen["pass"] = m
            seen["t_pass"] = time.perf_counter()
            raise KeyboardInterrupt   # the mode saves + exits cleanly
        if "Check FAILED" in m:
            seen["fail"] = m

    row = {"p": p, "engine": None, "arith": arith, "n": None}
    if arith == "auto":
        d = decide_arith(p, "prp")
        row["reason"] = d.reason
    t0 = time.perf_counter()
    t_run = t0
    with tempfile.TemporaryDirectory() as td:
        o = Options(exponent=p, mode="prp", proof=False, save_dir=td,
                    checklevel=1, arith=arith)
        try:
            eng = None
            if quick_check(p) is None:
                eng = create_engine(p, 8, device=dev, backend=o.backend,
                                    arith=o.arith, workload="prp")
                row["engine"] = type(eng).__name__
                row["arith"] = "fft3161" if row["engine"] == "Engine3161" \
                    else "gl64"
                row["n"] = eng.get_size()
            t_run = time.perf_counter()
            # run_prp_or_ll's progress lines, kept off the rows
            with contextlib.redirect_stdout(io.StringIO()):
                run_prp_or_ll(o, eng=eng, log=log)
        except KeyboardInterrupt:
            pass
        except Exception as e:   # noqa: BLE001 — a broken shape must
            # record FAIL and let the rest of the ladder run (repeated
            # GL failure raises RuntimeError; that is the very signal
            # this tool exists to catch)
            seen["error"] = f"{type(e).__name__}: {e}"
    t1 = time.perf_counter()
    row.update(seconds=t1 - t0, setup_s=t_run - t0)
    if "t_pass" in seen:
        it = int(seen["pass"].split("iter=")[1])
        window = seen["t_pass"] - t_run
        row.update(iter=it, window_s=window, save_s=t1 - seen["t_pass"],
                   ips=(it + max(math.isqrt(p), 2)) / window)
    if "error" in seen:
        row.update(ok=False, detail=seen["error"])
    elif "fail" in seen:
        row.update(ok=False, detail=seen["fail"])
    elif "pass" in seen:
        row.update(ok=True, detail=seen["pass"])
    else:
        row.update(ok=True, detail="run completed before any GL window")
    return row


def smoke_one(p: int, device=None) -> tuple[bool, float, str]:
    """(ok, seconds, detail) — ok when the first GL window verifies."""
    r = smoke_row(p, device)
    return r["ok"], r["seconds"], r["detail"]


def format_row(r: dict) -> str:
    ran = "quick check" if r["engine"] is None else \
        f"{r['engine']} {r['arith']} n={r['n']}"
    extra = ""
    if "window_s" in r:
        extra = (f" window {r['window_s']:.1f}s {r['ips']:.2f} iter/s "
                 f"save {r['save_s']:.1f}s")
    return (f"M{r['p']:<12} {'OK' if r['ok'] else 'FAIL':4s} "
            f"{r['seconds']:7.1f}s  {r['detail']}  [{ran}{extra}]")


def ladder(cap: int, device) -> list[dict]:
    """The rows of every bench exponent up to cap, in the working
    directory as it is."""
    from ..modes.bench import BENCH_EXPONENTS
    rows = []

    def run(p, arith):
        rows.append(smoke_row(p, device, arith))
        drop_tables()
        print(format_row(rows[-1]), flush=True)
        return rows[-1]

    for p in BENCH_EXPONENTS:
        if p > cap:
            continue
        r = run(p, "auto")
        if p <= BOTH_ARITH_MAX and r["engine"]:
            run(p, "fft3161" if r["arith"] == "gl64" else "gl64")
    return rows


def main(argv=None) -> int:
    from ..core import tune
    argv = sys.argv[1:] if argv is None else argv
    cap = int(argv[0]) if argv else 10 ** 18
    dev = tool_device()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="gl_smoke_") as td:
        os.chdir(td)
        try:
            records = tune.load(".")
            print(f"tune records in {td}: "
                  f"{sorted(records) if records else 'none'}", flush=True)
            rows = ladder(cap, dev)
        finally:
            os.chdir(cwd)
    bad = sum(1 for r in rows if not r["ok"])
    print("GL smoke:", "ALL OK" if not bad else f"{bad} FAILURES")
    print(json.dumps({"tool": "gl_smoke",
                      "card": device_name(dev),
                      "records": sorted(records), "rows": rows,
                      "ok": not bad}))
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
