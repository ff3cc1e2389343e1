"""Benchmark mode: PRP squaring throughput across the reference's fixed
exponent ladder and the PRMERS_SCORE metric.

Parity with the reference benchmark (reference: src/core/App.cpp:618-860:
27 exponents 127..600000001, per-size iter/s, PRMERS_SCORE =
100 * geomean(iter/s) / 400 against the RTX-4090 reference card
App.cpp:775-801). Sizes beyond the current backend's supported transform
are skipped with a note (the reference likewise skips OOM sizes).

Port: a copy of prmers_tpu/modes/bench.py (the -bench ladder; the port's
own prmers_tpu_torch/bench.py prints the one-exponent iter/s line);
run_bench and _bench_one take `device=` for create_engine.
"""

from __future__ import annotations

import dataclasses
import math
import time

from ..engine.factory import create_engine
from ..io.options import Options

BENCH_EXPONENTS = [
    127, 761, 1279, 9941, 21701, 86243, 216091, 756839, 1257787, 3021377,
    6972593, 13466917, 20996011, 24036583, 25964951, 30402457, 32582657,
    37156667, 42643801, 43112609, 57885161, 74207281, 77232917, 82589933,
    136279841, 332192831, 600000001,
]
SCORE_BASELINE = 400.0  # geomean reference (App.cpp:787)


@dataclasses.dataclass
class BenchResult:
    rows: list  # (exponent, n, iter_s)
    score: float
    elapsed: float


def _bench_one(p: int, iters: int, backend: str, log,
               device=None) -> tuple[int, float]:
    eng = create_engine(p, 2, device=device, backend=backend)
    n = eng.get_size()
    eng.set(0, 3)
    warm = max(iters // 8, 4)
    eng.square_mul_seq(0, [1] * warm)
    eng.sync()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * iters)
    eng.sync()
    dt = time.perf_counter() - t0
    return n, iters / dt


def run_bench(opts: Options, log=print, device=None) -> BenchResult:
    iters = opts.bench_iters or 64
    t0 = time.monotonic()
    rows = []
    logs = []
    for p in BENCH_EXPONENTS:
        if opts.exponent and p != opts.exponent:
            continue
        try:
            n, ips = _bench_one(p, iters, opts.backend, log, device)
        except (ValueError, AssertionError, MemoryError) as e:
            log(f"M{p}: skipped ({e})")
            continue
        rows.append((p, n, ips))
        log(f"M{p:>10}  n={n:>9}  {ips:10.2f} iter/s")
    score = 0.0
    if rows:
        gm = math.exp(sum(math.log(r[2]) for r in rows) / len(rows))
        score = 100.0 * gm / SCORE_BASELINE
        log(f"PRMERS_SCORE = {score:.2f}")
    return BenchResult(rows=rows, score=score,
                       elapsed=time.monotonic() - t0)
