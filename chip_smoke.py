#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (prmers_tpu_torch) on one card.

Run from the repository root with no arguments: python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero with no result:
  1. the card (nvidia-smi name and power limit) and the kernel build
     (nvcc on prmers_tpu_torch/csrc/*.cu, timed);
  2. every kernel wrapper (K1, K2 in modes sqr/fwd/mul, K3 with a = 1,
     a = 3 and sub2) against its plain torch version on the same inputs on
     the card, at n = 2^15, 2^18, 2^23 and 2^24. K3 takes K2's lazy output,
     as on the main path. Tolerance: none. The arithmetic is exact mod P:
     K1/K2 outputs are compared after canon, K3's digits and row carries
     bit for bit;
  3. the main path at p = 136279841 (n = 2^23), through create_engine and
     the Engine API the PRP driver calls: squarings, one x3, and one
     set_multiplicand + mul, checked against GMP big-int. The wrapper
     call counts of K1-K3 (one per call that launched the kernel) are
     reset just before and read just after; each must be > 0;
  4. the timed PRP chain at p = 136279841 (iter/s), and each kernel's time
     against its plain version at n = 2^23 (CUDA events);
  5. `python -m prmers_tpu_torch 756839 -noproof` in a subprocess: the
     PRP of M756839 (n = 2^15) must report prime.

The last three lines of standard output are the per-kernel JSON object,
the card's name and power limit, and {"ok": true, "device": {...}}.
"""

import json
import os
import shutil
import subprocess
import sys
import time

P_MAIN = 136279841
P_GOLDEN = 756839


def log(*args):
    print(*args, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np

    from prmers_tpu_torch import bench
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.engine.fourstep_engine import check_shape
    from prmers_tpu_torch.host import build_plan
    from prmers_tpu_torch.host import digits as dg
    from prmers_tpu_torch.host import gmp
    from prmers_tpu_torch.ops import build
    from prmers_tpu_torch.ops import fourstep as tfs
    from prmers_tpu_torch.ops import gl64 as gl
    from prmers_tpu_torch.ops import kernels as tk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = bench.card()
    log(f"[1] card: {card}")
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = not os.path.exists(build.library_path())
    build.lib()
    log(f"[1] kernels {'built' if built else 'reused'} in "
        f"{time.perf_counter() - t0:.3f} s ({build.library_path()})")

    # ---- 2: every kernel against its plain version -----------------------
    errs = {name: 0.0 for name in tk.KERNELS}

    def max_abs_err(a, b) -> float:
        a = gl.to_numpy_u64(a).reshape(-1)
        b = gl.to_numpy_u64(b).reshape(-1)
        bad = np.nonzero(a != b)[0]
        if bad.size == 0:
            return 0.0
        return float(max(abs(int(a[i]) - int(b[i])) for i in bad[:4096]))

    def record(name, what, got, want):
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        errs[name] = max(errs[name], e)
        log(f"[2]   {name} {what}: max_abs_err {e}")
        if e != 0.0:
            raise AssertionError(f"{name} {what} disagrees with its plain "
                                 f"version (max_abs_err {e})")

    def case(logn):
        n = 1 << logn
        p = P_MAIN if n == 1 << 23 else int(n * 16.5) | 1
        plan = build_plan(p, n=n)
        fp = tfs.FourStepPlan.from_plan(plan)
        check_shape(fp)
        t1 = time.perf_counter()
        t = tk.DevTables.from_host(tfs.build_tables(fp), dev)
        log(f"[2] n=2^{logn} p={p} (R1, R2, C)={t.shape}: tables "
            f"{time.perf_counter() - t1:.3f} s")
        rng = np.random.default_rng(logn)
        v = int.from_bytes(rng.bytes(p // 8 + 1), "little") % ((1 << p) - 1)
        x = gl.from_numpy_u64(dg.int_to_digits(v, plan.widths),
                              dev).reshape(t.shape)
        co = torch.from_numpy(rng.integers(0, 1 << 40, size=t.shape[:2],
                                           dtype=np.int64)).to(dev)
        s = tk.p1_carry_pass(t, x, co)
        sp = tk.p1_carry_plain(t, x, co)
        record("k1_p1c", f"n=2^{logn}", gl.canon64(s), gl.canon64(sp))
        for mode in ("sqr", "fwd", "mul"):
            u = gl.canon64(tk.fused_c_plain(t, sp, "fwd")) \
                if mode == "mul" else None
            got = tk.fused_c_pass(t, sp, mode, u=u)
            want = tk.fused_c_plain(t, sp, mode, u)
            record("k2_fused_c", f"n=2^{logn} {mode}", gl.canon64(got),
                   gl.canon64(want))
            if mode == "sqr":
                z = got                 # lazy (< 2^64), as K3 gets it
        for a, sub2 in ((1, False), (3, False), (1, True)):
            d, c = tk.p7_carry_pass(t, z, a=a, sub2=sub2)
            dw, cw = tk.p7_carry_plain(t, z, a, sub2)
            what = f"n=2^{logn} a={a} sub2={sub2}"
            record("k3_p7c", what + " digits", d, dw)
            record("k3_p7c", what + " carries", c, cw)
        return t, x, co, sp, z

    for logn in (15, 18):
        case(logn)
    big = case(23)
    case(24)

    # ---- 3: the main path at p = 136279841 -------------------------------
    log(f"[3] HAVE_GMP {gmp.HAVE_GMP}")
    if not gmp.HAVE_GMP:
        raise RuntimeError("libgmp is needed for the big-int check at "
                           f"p = {P_MAIN}")
    mp = (1 << P_MAIN) - 1
    K = 6
    eng = create_engine(P_MAIN, 8, device=dev)
    assert eng.get_size() == 1 << 23
    eng.sync()
    tk.reset_calls()
    t1 = time.perf_counter()
    eng.set(0, 3)
    eng.set(1, 3)
    eng.square_mul_seq(0, [1] * K)          # 3^(2^K)
    eng.square_mul(0, 3)                    # 3^(2^(K+1) + 1)
    eng.set_multiplicand(2, 0)
    eng.mul(1, 2)                           # 3^(2^(K+1) + 2)
    eng.sync()
    counts = dict(tk.calls)
    log(f"[3] main path: {K + 3} steps in {time.perf_counter() - t1:.3f} s; "
        f"wrapper calls {counts}")
    for name in tk.KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    t1 = time.perf_counter()
    want0 = gmp.powmod(3, (1 << (K + 1)) + 1, mp)
    want1 = gmp.mulmod(want0, 3, mp)
    got0 = eng.get_int(0)
    got1 = eng.get_int(1)
    log(f"[3] big-int check in {time.perf_counter() - t1:.3f} s: R0 "
        f"{got0 == want0}, R1 {got1 == want1}")
    if got0 != want0 or got1 != want1:
        raise AssertionError("main-path chain disagrees with GMP big-int")
    del eng

    # ---- 4: timings -------------------------------------------------------
    ips = bench.measure(P_MAIN, warm=16, iters=192)
    log(f"[4] PRP {ips:.6f} iter/s @ p={P_MAIN} ({card})")
    t, x, co, sp, z = big

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    pairs = {
        "k1_p1c": (lambda: tk.p1_carry_pass(t, x, co),
                   lambda: tk.p1_carry_plain(t, x, co)),
        "k2_fused_c": (lambda: tk.fused_c_pass(t, sp, "sqr"),
                       lambda: tk.fused_c_plain(t, sp, "sqr")),
        "k3_p7c": (lambda: tk.p7_carry_pass(t, z),
                   lambda: tk.p7_carry_plain(t, z)),
    }
    ms = {}
    for name, (kern, plain) in pairs.items():
        p0 = timed(plain, 3)
        k0 = timed(kern, 20)
        k1 = timed(kern, 20)
        p1 = timed(plain, 3)
        ms[name] = ((k0 + k1) / 2, (p0 + p1) / 2)
        log(f"[4] {name} n=2^23: kernel {ms[name][0]:.6f} ms, plain "
            f"{ms[name][1]:.6f} ms ({card})")

    # ---- 5: M756839 through the CLI ---------------------------------------
    run_dir = os.path.join(root, "build", "smoke_run")
    shutil.rmtree(run_dir, ignore_errors=True)    # no checkpoint to resume
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "prmers_tpu_torch",
                        str(P_GOLDEN), "-noproof", "-save-dir", run_dir],
                       cwd=root, capture_output=True, text=True, timeout=900)
    dt = time.perf_counter() - t1
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(f"[5] M{P_GOLDEN} PRP rc={r.returncode} in {dt:.3f} s: {tail}")
    if r.returncode != 0 or '"status":"P"' not in tail.replace(" ", ""):
        raise AssertionError(f"M{P_GOLDEN} was not reported prime:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")

    kernels = [{"name": name, "route": "cuda", "source": tk.SOURCES[name],
                "replaces": tk.REPLACES[name], "launches": counts[name],
                "max_abs_err": errs[name], "ms": ms[name][0],
                "plain_ms": ms[name][1]} for name in tk.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
