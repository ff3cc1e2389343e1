"""The timing method of the tools, audited on a few probes.

`python -m prmers_tpu_torch.tools.timing_audit [reps]` times every
P-shapes case (kernel and one-call twin, in the tool's order),
P-mulmod (as microbench times it) and P-bitcast these ways, and prints
one JSON line with the card's name and power limit:

  * "alloc": device_ms on a thunk that allocates its output inside each
    event pair (the wrapper without `out=`, as the tools timed before),
    every pair's ms, their mean, median and largest;
  * "out" ("twin_out"): device_ms on a thunk that fills an output
    allocated once before the first pair (`out=`), likewise;
  * "cupti_ms": the kernel's own duration, `torch.profiler` (CUPTI) over
    reps launches of the `out=` thunk, the kernel's device time over its
    launch count;
  * for the shape cases, "cold" and "cupti_cold_ms": "out" and "cupti_ms"
    with the L2 emptied before every launch (tools.l2_flush), the reads
    from HBM, as probe_shapes times them.

Beside them, an empty launch (a device sleep of 0 cycles) timed as
device_ms times a kernel, the floor of the method, and its device time
under the profiler.
"""

from __future__ import annotations

import functools
import json
import sys

from . import device_ms, l2_flush, require_card
from ..bench import card


def cupti_ms(fn, reps: int, key: str, flush=None) -> float | None:
    """The mean device ms of the kernels whose name holds key over reps
    calls of fn (each behind flush, where one is given), from
    torch.profiler's CUDA activity; None if the trace has no device time
    for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if key not in e.key:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        total += t
        count += e.count
    return total / count / 1e3 if count and total > 0 else None


def _pairs(t) -> dict:
    return {"pairs": list(t.pairs), "mean_ms": t.mean,
            "median_ms": t.median, "max_ms": t.max}


def measure(reps: int = 10) -> dict:
    import torch

    from ..ops import probes as pr
    from . import microbench
    from .probe_shapes import _library, library_out
    dev = require_card()
    flush = l2_flush(dev)
    rows = {}
    # every shape case in the tool's order: the kernel allocating in the
    # window, then into an output made before (warm, then cold), the twin
    for case in pr.SHAPE_CASES:
        xs = pr.shape_inputs(case, device=dev)
        key = "dot8_kernel" if case in "ben" else "copy_kernel"
        o, lo = pr.shape_out(case, dev), library_out(case, xs)
        kernel = functools.partial(pr.shape_case, case, *xs, out=o)
        rows[f"P-shapes {case}"] = {
            "alloc": _pairs(device_ms(lambda: pr.shape_case(case, *xs),
                                      reps)[0]),
            "out": _pairs(device_ms(kernel, reps)[0]),
            "twin_out": _pairs(device_ms(_library(case, xs, lo), reps)[0]),
            "cupti_ms": cupti_ms(kernel, reps, key),
            "cold": _pairs(device_ms(kernel, reps, flush)[0]),
            "cupti_cold_ms": cupti_ms(kernel, reps, key, flush)}
    ab = pr.rep_inputs("gl_mul", microbench.SHAPE, seed=1, device=dev)
    o = torch.empty((2,) + microbench.SHAPE, dtype=torch.int32, device=dev)
    R = microbench.REPS
    rows["P-mulmod"] = {
        "alloc": _pairs(device_ms(lambda: pr.mulmod(ab, R), reps)[0]),
        "out": _pairs(device_ms(lambda: pr.mulmod(ab, R, out=o), reps)[0]),
        "cupti_ms": cupti_ms(lambda: pr.mulmod(ab, R, out=o), reps,
                             "rep_kernel")}
    x = torch.from_numpy(pr.bitcast_pattern().view("int32")).to(dev)
    o = torch.empty((32, 128), dtype=torch.int8, device=dev)
    rows["P-bitcast"] = {
        "alloc": _pairs(device_ms(lambda: pr.bitcast(x), reps)[0]),
        "out": _pairs(device_ms(lambda: pr.bitcast(x, out=o), reps)[0]),
        "cupti_ms": cupti_ms(lambda: pr.bitcast(x, out=o), reps, "bitcast")}
    rows["empty launch"] = {
        "out": _pairs(device_ms(lambda: torch.cuda._sleep(0), reps)[0]),
        "cupti_ms": cupti_ms(lambda: torch.cuda._sleep(0), reps,
                             "spin_kernel")}
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 10
    rows = measure(reps)
    print(json.dumps({"tool": "timing_audit", "card": card(), "reps": reps,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
