"""Where a squaring's device time goes, on the card.

`python -m prmers_tpu_torch.profile <p> [steps] [-backend sharded]` runs
`steps` PRP squarings (a = 1) at exponent p through create_engine under
torch.profiler and prints one JSON line: the card, the device ms per
squaring of each CUDA kernel (summed by name) and its share, the device
time per squaring, the wall time per squaring in the traced window (it
ends in torch.cuda.synchronize()) and the device's idle share of that
window. The kernels run on one stream, so idle = 1 - device time / wall
time. Needs a card: without one it raises. Where the engine takes K9 (n =
2^15 ... 2^19) the squarings are one launch per 512 of them, so ask for
512 steps there: a window of 16 is mostly the launch and the profiler's
own start.

The pipeline is create_engine's: the default row carry, or what the JAX
package's switches ask for, e.g. `PRMERS_NO_ROWCARRY=1 python -m
prmers_tpu_torch.profile 136279841` for the block-carry pipeline. The
line names it and gives each port kernel's wrapper calls per squaring
(k4_axis0 and k7_block_carry there: on the device K4 inverse runs as
`axis_fft_kernel<3, ...>` (mode AX_K3A, K3's r1 inverse without its
carry; K3 itself is `k3_kernel<...>`), and K4 forward as
`axis_fft_kernel<4, ...>`).

With `-backend sharded`, under `python -m torch.distributed.run
--nproc_per_node=<s>`, it profiles the mesh on rank 0's card (every rank
runs the squarings): the mesh engine, or with PRMERS_NO_ROWCARRY=1 the
block-carry ShardedStep, whose K8 counts as k8_local among the wrapper
calls and runs as `k7_kernel` on the device. The line adds the world size,
the collectives per squaring (parallel/dist.counts: to_r2, to_r1,
ring_prev) and the device ms per squaring of the NCCL kernels, whose names
start with "nccl" (none at s = 1, where the mesh runs no collective). An
NCCL kernel's time includes its wait for the other ranks, so at s > 1
device time can exceed the work and the idle share reads low.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict


def profile(p: int, steps: int = 16, warm: int = 4,
            backend: str | None = None) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from .bench import card
    from .engine.factory import create_engine, pipeline_from_env
    from .ops import kernels as tk
    from .parallel import dist
    from .parallel.sharded_kernels import ShardedStep
    from .utils import digits as dg
    dev = dist.device("cuda")
    pipe = pipeline_from_env()
    if backend == "sharded" and not pipe.rowcarry:
        st = ShardedStep(p, pipe=pipe, device=dev)
        st.set_digits(dg.int_to_digits(3, st.plan.widths))
        n, fp = st.plan.n, st.fp

        def run(k):
            st.step(k)
    else:
        eng = create_engine(p, 2, device=dev, backend=backend)
        eng.set(0, 3)
        n = eng.get_size()
        fp = eng.tables.fp if hasattr(eng, "tables") else eng.t.fp

        def run(k):
            eng.square_mul_seq(0, [1] * k)
    run(warm)
    torch.cuda.synchronize()
    dist.barrier()
    tk.reset_calls()
    coll0 = dict(dist.counts)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us = defaultdict(float)
    for e in prof.events():
        # the kernels only: NCCL's "nccl:..." ranges are annotations that
        # span its kernels on the device timeline
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            us[e.name] += e.time_range.elapsed_us()
    dev_ms = sum(us.values()) / 1e3 / steps
    if dev_ms == 0.0:
        raise RuntimeError("the profiler recorded no device time")
    wall_ms = wall * 1e3 / steps
    kernels = sorted(((name, t / 1e3 / steps) for name, t in us.items()),
                     key=lambda kv: -kv[1])
    return {"p": p, "n": n, "card": card(), "steps": steps,
            "pipeline": repr(fp.pipe),
            "world_size": dist.process_count(),
            "wrapper_calls_per_squaring": {
                name: c / steps for name, c in tk.calls.items() if c},
            "collectives_per_squaring": {
                name: (c - coll0[name]) / steps
                for name, c in dist.counts.items() if c > coll0[name]},
            "collective_ms_per_squaring": sum(
                ms for name, ms in kernels if name.startswith("nccl")),
            "device_ms_per_squaring": dev_ms,
            "wall_ms_per_squaring": wall_ms,
            "idle_share": 1.0 - dev_ms / wall_ms,
            "kernels": [{"name": name, "ms": ms, "share": ms / dev_ms}
                        for name, ms in kernels]}


def main(argv=None) -> int:
    from .parallel import dist
    argv = sys.argv[1:] if argv is None else list(argv)
    backend = None
    if "-backend" in argv:
        i = argv.index("-backend")
        backend = argv[i + 1]
        del argv[i:i + 2]
    p = int(argv[0])
    steps = int(argv[1]) if len(argv) > 1 else 16
    dist.init_from_env()
    try:
        line = profile(p, steps, backend=backend)
        if dist.is_primary():
            print(json.dumps(line))
    finally:
        dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
