"""Autotuning cache: measured iteration rates per transform size.

The reference persists `tune.txt` / `ztune.txt` throughput+capacity tables
that plan selection consults (reference: third_party/aevum/tune.cpp,
TuneEntry.cpp, tune.h:18-30). TPU analog: `-tune` measures PRP iter/s per
transform size on the attached device and persists prmers_tune.json; the
engine factory and benchmark report consult it. ROE-based capacity tuning
(ztune) does not apply — the integer NTT is exact; capacity is the static
convolution bound from the plan.

Port: a copy of prmers_tpu/core/tune.py with three changes. TUNE_FILE is
the port's own, prmers_torch_tune.json: the repository's committed
prmers_tune.json holds TPU v5e rates under the JAX package's engine
names (Engine3161 among them), and no number taken on a TPU may route
the port. run_tune takes `device=` down to create_engine. Its mesh
branch asks torch.cuda.is_available() in place of jax's platform and
measures the port's MeshEngine on a group of one rank (no collective;
parallel/mesh_engine.py) where mesh_eligible(p, 1) holds, recording it
as "MeshEngine", which the factory's one-card routing reads.
"""

from __future__ import annotations

import json
import os
import time

TUNE_FILE = "prmers_torch_tune.json"

# the reference's benchmark exponent ladder, truncated to sizes a single
# chip can set up quickly (reference: src/core/App.cpp:670-674)
TUNE_EXPONENTS = (127, 9941, 216091, 756839, 3021377, 25964951,
                  57885161, 136279841)


def tune_path(save_dir: str = ".") -> str:
    return os.path.join(save_dir, TUNE_FILE)


def load(save_dir: str = ".") -> dict:
    try:
        with open(tune_path(save_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def save(data: dict, save_dir: str = ".") -> None:
    with open(tune_path(save_dir), "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)


def record(n: int, backend: str, ips: float, save_dir: str = ".") -> None:
    data = load(save_dir)
    key = str(n)
    ent = data.setdefault(key, {})
    prev = ent.get(backend, 0.0)
    ent[backend] = max(float(ips), prev)   # keep the best observed rate
    save(data, save_dir)


def lookup(n: int, backend: str, save_dir: str = ".") -> float:
    return float(load(save_dir).get(str(n), {}).get(backend, 0.0))


def measure_ips(eng, iters: int = 64, warm: int = 8) -> float:
    """Iterations/second of the PRP squaring chain on an engine.

    The warm-up chain must have the SAME length as the timed one — the
    sequence ops specialize on the chain length, so a different warm
    length would leave the compile inside the timed region."""
    eng.set(0, 3)
    eng.square_mul_seq(0, [1] * iters)
    eng.sync()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * iters)
    eng.sync()
    return iters / (time.perf_counter() - t0)


def run_tune(opts, log=print, device=None):
    """Measure every ladder size on the attached device — BOTH arithmetic
    paths — and persist, so the auto policy's measured branch becomes
    live (reference: tune.txt consulted by bestFit,
    third_party/aevum/tune.cpp)."""
    from ..engine.factory import create_engine

    iters = opts.bench_iters or 64
    results = {}
    ariths = ("gl64", "fft3161") if getattr(opts, "arith", "auto") == \
        "auto" else (opts.arith,)
    for p in TUNE_EXPONENTS:
        if opts.exponent and p > opts.exponent:
            break
        for arith in ariths:
            try:
                eng = create_engine(p, 2, backend=opts.backend,
                                    arith=arith, device=device)
            except Exception as e:  # noqa: BLE001 — skip unfittable sizes
                log(f"tune: skip p={p} {arith}: {e}")
                continue
            try:
                ips = measure_ips(eng, iters=iters)
            except Exception as e:  # noqa: BLE001
                log(f"tune: measure failed p={p} {arith}: {e}")
                del eng
                continue
            n = eng.get_size()
            record(n, type(eng).__name__, ips, opts.save_dir)
            results[(p, arith)] = ips
            log(f"tune: p={p} {arith} n={n} {ips:.2f} iter/s")
            del eng
        # a one-rank mesh engine can beat the single-card engine at a
        # size (the JAX package's did, 1.58x at n=2^19 on a TPU v5e);
        # measure it per size so the factory's record-driven routing
        # (_mesh_beats_fourstep) picks the winner instead of assuming
        try:
            import torch
            if torch.cuda.is_available():
                from ..parallel.mesh_engine import MeshEngine, mesh_eligible
                if mesh_eligible(p, 1):
                    eng = MeshEngine(p, 2, device=device)
                    ips = measure_ips(eng, iters=iters)
                    record(eng.get_size(), "MeshEngine", ips,
                           opts.save_dir)
                    results[(p, "mesh")] = ips
                    log(f"tune: p={p} mesh n={eng.get_size()} "
                        f"{ips:.2f} iter/s")
                    del eng
        except Exception as e:  # noqa: BLE001
            log(f"tune: mesh measure failed p={p}: {e}")
    return results
