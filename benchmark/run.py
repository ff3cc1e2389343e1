"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run: the seed draws the exponent p from the configuration's band; the
run builds what a default PRP run of p builds through the port's CLI
(io/cli.parse_args with the traffic's options, create_engine(p, 8, ...,
workload="prp"), the proof set as app.py builds it) with a fresh save
directory under TMPDIR, warms the engine's shapes on scratch registers,
and then calls the PRP driver, modes/prp_ll.run_prp_or_ll, from
iteration 0. The window opens at the PRP driver's first test squaring,
after its preamble, and closes after --seconds with the device
synchronized (window.py); set-up, setup_s, is everything from the
process's start to the window's. Then the harness reads the registers
the PRP driver left (R0 and the Gerbicz-Li accumulator R1), frees the
engine, runs the plain reference (reference.py) for as many iterations
as the PRP driver made, and judges (judge.py).

The last line on standard output is one JSON object: correct, attempted
(the test's squarings), failed (those that failed Gerbicz-Li checks
rolled back), metrics (with --trace 0 the cell's end-to-end metrics,
with --trace 1 its per-layer ones, read by metrics/<name>.py from a
torch.profiler trace of the window), device, in a traced run breakdown,
and last `check`: each number compared with its limit. The same
numbers close standard error. Everything else the run prints goes to
standard error.

It needs a card: without one, or with fewer than the cell asks for, or
if JAX or the JAX package is loaded once the window has closed, it exits
with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

from . import judge, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "prmers_tpu")
# the program's caches, at fixed paths inside the checkout (the port's
# kernel library builds into build/kernels/ by itself, ops/build.py)
CACHE_ENV = {"TRITON_CACHE_DIR": "build/triton",
             "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
             "CUDA_CACHE_PATH": "build/cuda_cache"}
WARM_SQUARINGS = 8       # the warm-up's squarings on a scratch register


def loaded_forbidden() -> list[str]:
    """JAX or the JAX package among the loaded modules, by whole
    top-level name (prmers_tpu_torch is not prmers_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metric_path(name: str):
    return spec.BENCH_DIR / "metrics" / f"{name}.py"


def load_metric(name: str):
    import benchmark.metrics  # noqa: F401  (the readers' package)
    modname = "benchmark.metrics." + re.sub(r"\W", "_", name)
    sp = importlib.util.spec_from_file_location(modname, metric_path(name))
    mod = importlib.util.module_from_spec(sp)
    sys.modules[modname] = mod
    sp.loader.exec_module(mod)
    return mod


def card_info(dev) -> dict:
    """The card's name, power limit, SM count and top SM clock."""
    import torch
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
        capture_output=True, text=True, check=True)
    name, watts, mhz = [v.strip() for v in
                        r.stdout.strip().splitlines()[0].split(",")]
    return {"name": name, "power_limit_w": float(watts),
            "sm_clock_hz": float(mhz) * 1e6,
            "sms": torch.cuda.get_device_properties(dev).multi_processor_count}


def _log_reader(lines: list):
    def log(msg=""):
        lines.append(str(msg))
        print(msg, file=sys.stderr)
    return log


def check_outcomes(lines: list[str]) -> dict:
    """The PRP driver's Gerbicz-Li verdicts and the iterations each failure
    rolled back, from its log (modes/prp_ll.py's messages)."""
    passed = failed = rolled = 0
    at = None
    for line in lines:
        if "[Gerbicz Li] Check passed!" in line:
            passed += 1
        elif m := re.search(r"Check FAILED! iter=(\d+)", line):
            failed += 1
            at = int(m.group(1))
        elif (m := re.search(r"Restore iter=(\d+)", line)) and at is not None:
            itersave = int(m.group(1))
            rolled += at - (itersave + 1 if itersave > 0 else 0)
            at = None
    return {"passed": passed, "failed": failed, "rolled_back": rolled}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", make_engine=None) -> dict:
    """One run of a cell on `device` (the CPU only in the tests). Returns
    the result line's fields and what the metrics read; `make_engine`
    replaces create_engine (the tests' faults)."""
    import torch
    from prmers_tpu_torch.core.proof import ProofSet, best_power
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.io.cli import parse_args
    from prmers_tpu_torch.modes.prp_ll import run_prp_or_ll
    from prmers_tpu_torch.ops import kernels as tk

    from . import reference, tracing
    from .window import R0, R1, R3, Window, WindowClosed

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    traffic = cell.traffic
    p = spec.exponent(cell.config, traffic, seed)
    save_dir = tempfile.mkdtemp(prefix=f"prmers_bench_{cell.name}_")
    log_lines: list[str] = []
    log = _log_reader(log_lines)
    marks = [("imports", time.perf_counter())]
    try:
        with contextlib.redirect_stdout(sys.stderr):
            opts = parse_args([str(p), "-save-dir", save_dir]
                              + list(traffic.get("cli", [])))
            eng = (make_engine or create_engine)(
                p, 8, device=dev, backend=opts.backend, arith=opts.arith,
                workload="prp")
            sync()
            marks.append(("engine", time.perf_counter()))
            proof_set = None
            if opts.mode == "prp" and opts.proof and p > 128:  # app.py
                power = opts.proof_power or best_power(p)
                proof_set = ProofSet(p, power, widths=eng.widths,
                                     save_dir=opts.save_dir,
                                     known_factors=opts.known_factors)
            # warm the cell's shapes on the scratch registers R2, R3 (the
            # PRP driver writes both before it reads them)
            three = np.zeros(eng.get_size(), dtype=np.uint64)
            three[0] = 3
            eng.set_digits(2, three)
            eng.square_mul_seq(2, [1] * WARM_SQUARINGS)
            eng.set_multiplicand(3, 2)
            eng.mul(2, 3)
            # a set checklevel puts full checks in a window (the default,
            # 0, one every int(600000 / B) blocks, none): their x3, get_int
            if opts.gerbiczli and opts.checklevel > 0:
                eng.square_mul(2, 3)
                eng.get_int(2)
            sync()
            marks.append(("warm-up", time.perf_counter()))
            prof = None
            if trace:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
            win = Window(eng, seconds, sync, traced=trace,
                         on_open=prof.start if prof is not None else None)
            win.install()
            calls0 = dict(tk.calls)
            try:
                run_prp_or_ll(opts, eng=eng, proof_set=proof_set, log=log)
                win.close()
            except WindowClosed:
                pass
            finally:
                win.finish()
                if prof is not None and win.t0 is not None:
                    prof.stop()
            win.uninstall()
            if win.t0 is None:
                raise RuntimeError("the PRP driver made no test squaring")
            t_setup = win.t0 - T_START
            marks.append(("preamble", win.t0))
        calls = {k: v - calls0.get(k, 0) for k, v in tk.calls.items()
                 if v - calls0.get(k, 0)}
        summary = tracing.summarize(prof) if prof is not None else None
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        widths = eng.widths.copy()
        prog = {"r0": eng.get_digits(R0), "r1": eng.get_digits(R1)}
        n = eng.get_size()
        del eng, proof_set
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)

    outcome = check_outcomes(log_lines)
    attempted = win.squarings[R0]
    net = attempted - outcome["rolled_back"]
    t = time.perf_counter()
    r0, r1, roundoff = reference.prp_state(p, net, dev)
    ref_s = time.perf_counter() - t
    checks = judge.compare(p, prog, widths, r0, r1, outcome)
    sq = {"test": attempted, "replay": win.squarings[R3],
          "all": sum(win.squarings.values())}
    return {"p": p, "n": n, "seed": seed, "window_s": win.window_s,
            "setup_s": t_setup, "attempted": attempted,
            "failed": outcome["rolled_back"], "net": net,
            "checks": checks, "gl": outcome, "calls": calls,
            "squarings": sq, "trace": summary, "memory_peak_bytes": peak,
            "reference_s": ref_s, "roundoff": roundoff,
            "spans": win.spans,
            "setup_parts": {name: t - prev for (name, t), prev in zip(
                marks, [T_START] + [t for _, t in marks[:-1]])}}


def metric_context(cell: spec.Cell, res: dict, card: dict | None) -> dict:
    return {"net": res["net"], "window_s": res["window_s"],
            "setup_s": res["setup_s"], "squarings": res["squarings"],
            "calls": res["calls"], "trace": res["trace"],
            "plan": cell.config["plan"], "card": card}


def read_metrics(metrics, ctx: dict) -> dict:
    """Each metric's reader on the run's context; a metric whose reader
    finds nothing to read is left out."""
    out = {}
    for m in metrics:
        v = load_metric(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def write_spans(cell: spec.Cell, res: dict) -> str:
    """The harness's spans of the window, kept in memory until now."""
    path = os.path.join(tempfile.gettempdir(),
                        f"prmers_bench_spans_{cell.name}_{res['seed']}.json")
    t0 = res["spans"][0][1] if res["spans"] else 0.0
    with open(path, "w") as f:
        json.dump([[name, s - t0, e - t0] for name, s, e in res["spans"]], f)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for key, rel in CACHE_ENV.items():
        os.environ[key] = str(spec.ROOT / rel)
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 10
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    card = card_info(dev)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": judge.correct(res["checks"]),
            "attempted": res["attempted"], "failed": res["failed"]}
    if args.trace:
        tr = res["trace"]
        if not tr or tr["busy_s"] <= 0:
            print("benchmark: the profiler recorded no device time",
                  file=sys.stderr)
            return 12
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
    metrics = cell.per_layer if args.trace else cell.end_to_end
    line["metrics"] = read_metrics(metrics, metric_context(cell, res, card))
    line["device"] = device
    if args.trace:
        from .tracing import breakdown
        line["breakdown"] = breakdown(res["trace"])
    line["check"] = res["checks"]
    found = loaded_forbidden()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 11
    spans = write_spans(cell, res)
    print(f"[bench] {cell.name} seed {args.seed}: p = {res['p']}, n = "
          f"{res['n']}, {card['name']}, {card['power_limit_w']} W; window "
          f"{res['window_s']:.6f} s, {res['attempted']} test squarings, "
          f"{res['squarings']['replay']} replayed, checks {res['gl']}; "
          f"reference {res['reference_s']:.3f} s, rounding error "
          f"{res['roundoff']:.6f}; spans in {spans}", file=sys.stderr)
    print("[bench] set-up s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["setup_parts"].items()),
        file=sys.stderr)
    t0 = res["spans"][0][1] if res["spans"] else 0.0
    for name, s, e in res["spans"]:
        if e - s >= 0.05:
            print(f"[bench] span {name} {s - t0:.3f} {e - t0:.3f}",
                  file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
