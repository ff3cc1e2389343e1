"""Where a squaring's device time goes, on the card.

`python -m prmers_tpu_torch.profile <p> [steps]` runs `steps` PRP
squarings (a = 1) at exponent p through create_engine under torch.profiler
and prints one JSON line: the card, the device ms per squaring of each
CUDA kernel (summed by name) and its share, the device time per squaring,
the wall time per squaring in the traced window (it ends in
torch.cuda.synchronize()) and the device's idle share of that window. The
kernels run on one stream, so idle = 1 - device time / wall time. Needs a
card: without one it raises. Where the engine takes K9 (n = 2^15 ...
2^19) the squarings are one launch per 512 of them, so ask for 512 steps
there: a window of 16 is mostly the launch and the profiler's own start.

The pipeline is create_engine's: the default row carry, or what the JAX
package's switches ask for, e.g. `PRMERS_NO_ROWCARRY=1 python -m
prmers_tpu_torch.profile 136279841` for the block-carry pipeline. The
line names it and gives each port kernel's wrapper calls per squaring
(k4_axis0 and k7_block_carry there: K4 forward and inverse share the
`axis_dft_kernel` name with K1 and K3a on the device).
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict


def profile(p: int, steps: int = 16, warm: int = 4) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from .bench import card
    from .engine.factory import create_engine
    from .ops import kernels as tk
    eng = create_engine(p, 2, device="cuda")
    eng.set(0, 3)
    eng.square_mul_seq(0, [1] * warm)
    torch.cuda.synchronize()
    tk.reset_calls()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.square_mul_seq(0, [1] * steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us()
    dev_ms = sum(us.values()) / 1e3 / steps
    if dev_ms == 0.0:
        raise RuntimeError("the profiler recorded no device time")
    wall_ms = wall * 1e3 / steps
    kernels = sorted(((name, t / 1e3 / steps) for name, t in us.items()),
                     key=lambda kv: -kv[1])
    return {"p": p, "n": eng.get_size(), "card": card(), "steps": steps,
            "pipeline": repr(eng.t.fp.pipe),
            "wrapper_calls_per_squaring": {
                name: c / steps for name, c in tk.calls.items() if c},
            "device_ms_per_squaring": dev_ms,
            "wall_ms_per_squaring": wall_ms,
            "idle_share": 1.0 - dev_ms / wall_ms,
            "kernels": [{"name": name, "ms": ms, "share": ms / dev_ms}
                        for name, ms in kernels]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = int(argv[0])
    steps = int(argv[1]) if len(argv) > 1 else 16
    print(json.dumps(profile(p, steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
