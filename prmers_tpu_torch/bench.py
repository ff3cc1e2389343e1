"""Benchmark: PRP squarings/sec at p=136279841 on the CUDA card.

`python -m prmers_tpu_torch.bench` prints ONE JSON line with the keys of
the JAX package's bench.py: {"metric", "value", "unit", "vs_baseline"},
the baseline being the RTX 4090's ~1225 iter/s (BASELINE.md). The device
name and power limit go to stderr. The timed region ends in
torch.cuda.synchronize(). A failure fails the run: there is no ladder of
slower pipelines to fall back on.

On the mesh, one process per card:
`python -m torch.distributed.run --nproc_per_node=<s> -m
prmers_tpu_torch.bench -backend sharded` times the mesh engine
(parallel/mesh_engine.MeshEngine) on s cards; rank 0 prints the line,
with "world_size": s beside the keys above.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BASELINE_4090 = 1225.0
P_BENCH = 136279841
WARM = 16
ITERS = 192


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def measure(p: int = P_BENCH, warm: int = WARM, iters: int = ITERS,
            pipe=None, backend: str | None = None) -> float:
    """Timed PRP squaring chain on the card; returns iter/s. `pipe` (an
    ops/fourstep.Pipeline) overrides the engine's default pipeline, e.g.
    Pipeline(chain=False) for the three-kernel step where K9 would run;
    `backend` is create_engine's ("sharded": the mesh over the process
    group, every rank calling this together)."""
    import torch

    from .engine.factory import create_engine
    from .parallel import dist
    eng = create_engine(p, 2, pipe=pipe, backend=backend,
                        device=dist.device("cuda"))
    eng.set(0, 3)
    eng.square_mul_seq(0, [1] * warm)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * iters)
    torch.cuda.synchronize()
    return iters / (time.perf_counter() - t0)


def main(argv=None) -> None:
    from .parallel import dist
    argv = sys.argv[1:] if argv is None else argv
    backend = argv[argv.index("-backend") + 1] if "-backend" in argv \
        else None
    dist.init_from_env()
    try:
        ips = measure(backend=backend)
        if dist.is_primary():
            print(f"bench: {card()}", file=sys.stderr)
            line = {
                "metric": f"PRP iter/s @ p={P_BENCH}",
                "value": round(ips, 2),
                "unit": "iter/s",
                "vs_baseline": round(ips / BASELINE_4090, 4),
            }
            if dist.initialized():
                line["world_size"] = dist.process_count()
            print(json.dumps(line))
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
