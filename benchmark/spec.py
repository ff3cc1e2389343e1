"""BENCHMARK.json, the configuration files and the traffic mixes, and the
exponent a seed draws. Nothing here imports torch or the port."""

from __future__ import annotations

import dataclasses
import json
import math
import random
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# Miller-Rabin with these bases is exact below 3.3e24
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    chips: int
    end_to_end: tuple     # BENCHMARK.json's end-to-end metrics of the cell
    per_layer: tuple      # its per-layer metrics


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    """A metric with a `workloads` key holds for the cells it lists; a
    per-layer metric without one for every cell that reports the
    end-to-end metric it moves; an end-to-end one for every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    w = _by_name(bench["workloads"], name, "workload")
    c = _by_name(bench["configs"], w["config"], "configuration")
    with open(root / c["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = tuple(m for m in bench["end_to_end"] if _applies(m, name))
    reported = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"]
                  if _applies(m, name, reported))
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=layer)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for q in _MR_BASES:
        if n % q == 0:
            return n == q
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def first_block(p: int) -> int:
    """Squarings before the PRP driver's first Gerbicz-Li block boundary:
    boundaries fall where the squarings left, p - i, are a multiple of
    B = isqrt(p), so the first at i = p mod B (B when that is 0)."""
    b = math.isqrt(p)
    return p % b or b


def exponent(config: dict, traffic: dict, seed: int) -> int:
    """The prime exponent a seed tests: drawn uniformly from the
    configuration's band, among those whose first block is the share of B
    the traffic asks for (`first_block_share`: [low, high), or any)."""
    lo, hi = config["exponent_band"]
    share = traffic.get("first_block_share")
    rng = random.Random(seed)
    start = lo | 1
    for _ in range(1_000_000):
        p = rng.randrange(start, hi + 1, 2) if hi > start else start
        if not is_prime(p):
            continue
        if share is not None:
            s = first_block(p) / math.isqrt(p)
            if not share[0] <= s < share[1]:
                continue
        return p
    raise ValueError(f"no prime exponent in {config['exponent_band']} "
                     f"with a first block in {share}")
