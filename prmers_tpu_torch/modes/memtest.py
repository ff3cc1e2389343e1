"""Device memory / determinism test.

The reference memtest scans VRAM with address, inversion, and
modulo-stride patterns and reports bandwidth + bit errors
(reference: src/modes/RunMemTest.cpp:421-437). TPU HBM is ECC-protected,
so the meaningful analog is a determinism check (SURVEY.md §5.2): the same
squaring chain from the same state must be bit-identical across repeats —
any mismatch indicates memory or logic faults — plus host<->device
round-trip integrity on random payloads and an effective-bandwidth report.

Port: a copy of prmers_tpu/modes/memtest.py; run_memtest takes
`device=` for create_engine.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..engine.factory import create_engine
from ..io.options import Options


@dataclasses.dataclass
class MemtestResult:
    p: int
    passes: int
    errors: int
    roundtrip_errors: int
    ips: float
    effective_gbps: float
    elapsed: float


def run_memtest(opts: Options, log=print, device=None) -> MemtestResult:
    p = opts.exponent or 756839
    passes = max(opts.bench_iters or 4, 1)
    chain = 64
    eng = create_engine(p, 2, device=device, backend=opts.backend,
                        arith=opts.arith)
    n = eng.get_size()
    rng = np.random.default_rng(0xC0FFEE)
    mp = (1 << p) - 1
    t0 = time.monotonic()

    errors = 0
    rt_errors = 0
    ips = 0.0
    for it in range(passes):
        seed = int.from_bytes(rng.bytes(p // 8), "little") % mp
        # round-trip integrity
        eng.set_int(0, seed)
        if eng.get_int(0) != seed:
            rt_errors += 1
            log(f"memtest: ROUND-TRIP MISMATCH in pass {it}")
        # determinism: identical chains must produce identical digits
        eng.set_int(0, seed)
        ts = time.perf_counter()
        eng.square_mul_seq(0, [1] * chain)
        eng.sync()
        ips = chain / (time.perf_counter() - ts)
        d1 = eng.get_digits(0).copy()
        eng.set_int(1, seed)
        eng.square_mul_seq(1, [1] * chain)
        d2 = eng.get_digits(1)
        if not np.array_equal(d1, d2):
            errors += 1
            log(f"memtest: DETERMINISM MISMATCH in pass {it} "
                f"({int((d1 != d2).sum())} digits differ)")
        log(f"memtest pass {it + 1}/{passes}: "
            f"{'OK' if errors == rt_errors == 0 else 'ERRORS'} "
            f"({ips:.1f} iter/s)")

    # effective bandwidth: one squaring streams the register several times;
    # report the measured digit traffic rate as a lower bound
    bytes_per_iter = 8 * n * 6  # u64 digits, ~3 read+write sweeps
    gbps = ips * bytes_per_iter / 1e9
    r = MemtestResult(p=p, passes=passes, errors=errors,
                      roundtrip_errors=rt_errors, ips=ips,
                      effective_gbps=gbps,
                      elapsed=time.monotonic() - t0)
    log(f"memtest: {passes} passes, {errors} determinism errors, "
        f"{rt_errors} round-trip errors, ~{gbps:.1f} GB/s effective")
    return r
