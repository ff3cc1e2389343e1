"""Benchmark: PRP squarings/sec at p=136279841 on the CUDA card.

`python -m prmers_tpu_torch.bench` prints ONE JSON line with the keys of
the JAX package's bench.py: {"metric", "value", "unit", "vs_baseline"},
the baseline being the RTX 4090's ~1225 iter/s (BASELINE.md). The device
name and power limit go to stderr. The timed region ends in
torch.cuda.synchronize(). A failure fails the run: there is no ladder of
slower pipelines to fall back on.

`python -m prmers_tpu_torch.bench --ab <root>` compares this tree with
another checkout of the repository at <root> (e.g. the parent commit
unpacked with `git archive` into build/parent): each tree's measure() in
its own process, in turns root, this, this, root, on the same card; one
JSON line with both runs of each and the change's mean against the
root's, in percent.

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


def ab(root: str, p: int = P_BENCH) -> dict:
    """iter/s at p of the checkout at root and of this tree, in turns."""
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from prmers_tpu_torch import bench; "
            f"print('IPS', bench.measure({p}))")
    got = {"root": [], "this": []}
    for label in ("root", "this", "this", "root"):
        r = subprocess.run([sys.executable, "-c", code],
                           cwd=root if label == "root" else here,
                           capture_output=True, text=True, check=True)
        ips = [ln for ln in r.stdout.splitlines() if ln.startswith("IPS")]
        got[label].append(float(ips[-1].split()[1]))
    a, b = sum(got["root"]) / 2, sum(got["this"]) / 2
    return {"metric": f"PRP iter/s @ p={p}", "root": root,
            "root_runs": got["root"], "this_runs": got["this"],
            "delta_percent": 100 * (b - a) / a, "card": card()}


def main(argv=None) -> None:
    from .parallel import dist
    argv = sys.argv[1:] if argv is None else argv
    if "--ab" in argv:
        print(json.dumps(ab(argv[argv.index("--ab") + 1])))
        return
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
