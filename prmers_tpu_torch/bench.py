"""Benchmark: PRP squarings/sec at p=136279841 on the CUDA card.

`python -m prmers_tpu_torch.bench` prints ONE JSON line with the keys of
the JAX package's bench.py: {"metric", "value", "unit", "vs_baseline"},
the baseline being the RTX 4090's ~1225 iter/s (BASELINE.md). The device
name and power limit go to stderr. The timed region ends in
torch.cuda.synchronize(). A failure fails the run: there is no ladder of
slower pipelines to fall back on.
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
            pipe=None) -> float:
    """Timed PRP squaring chain on the card; returns iter/s. `pipe` (an
    ops/fourstep.Pipeline) overrides the engine's default pipeline, e.g.
    Pipeline(chain=False) for the three-kernel step where K9 would run."""
    import torch

    from .engine.factory import create_engine
    from .engine.fourstep_engine import FourStepEngine
    eng = (create_engine(p, 2, device="cuda") if pipe is None
           else FourStepEngine(p, 2, device="cuda", pipe=pipe))
    eng.set(0, 3)
    eng.square_mul_seq(0, [1] * warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * iters)
    torch.cuda.synchronize()
    return iters / (time.perf_counter() - t0)


def main() -> None:
    ips = measure()
    print(f"bench: {card()}", file=sys.stderr)
    print(json.dumps({
        "metric": f"PRP iter/s @ p={P_BENCH}",
        "value": round(ips, 2),
        "unit": "iter/s",
        "vs_baseline": round(ips / BASELINE_4090, 4),
    }))


if __name__ == "__main__":
    main()
