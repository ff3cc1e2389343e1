"""The C = 8192 lane-tiled row carry on the card: correctness and rate
against the canonical-digit hybrid at the 600M-class shape (n = 2^25, the
smallest production C = 8192 plan, T = 2 carry units a row).

Twin of the JAX package's tools/lanecarry_device_check.py, with the four
cases of tools/lanecarry_repro.py folded in. Usage:

    python -m prmers_tpu_torch.tools.lanecarry_check

Each variant is a FourStepEngine at p = int(2^25 * 16.2) | 1 on its
ops/fourstep.Pipeline: "lanecarry" the default (the row carry, K1 and K3
with T = 2 units a row), "hybrid" Pipeline(xla_carry=True) (K4, the
C-transform, K4 inverse, then carry_full). Against big-int, on each:
  chain      3, then the squarings of a = [1, 3, 1]
  wrap       (M_p - 5)^2 * 7 by square_mul (the repro's sq_dense)
  roundtrip  set M_p - 5, get it back
  sq_small   5^2 * 7
  seq_dense  (M_p - 5)^2 * 7 by square_mul_seq
then 48 timed squarings (square_mul_seq after a warm chain of the same
length, ending in torch.cuda.synchronize()) in turns: lanecarry, hybrid,
hybrid, lanecarry.

Changes from the JAX tools: both variants run in one process (the port's
pipeline is an argument, not a switch read at trace time, and no worker
crash can poison the card's client), the repro's cases run on both
variants, and the rate is the mean of each variant's two turns. The
wrap's big-int value is 175, as M_p - 5 = -5 mod M_p: the JAX tool's
`(mp - 5) ** 2 * 7 % mp` squares a 543-million-bit Python int, which
Python's Karatsuba does not finish in the tool's 600 s. Prints a
RESULT line a variant and one JSON line; exit 1 on any mismatch. Runs on
the card, or on the CPU under PRMERS_PLATFORM=cpu (tests hold it at a
small plan with a forced T = 2).
"""

from __future__ import annotations

import json
import sys
import time

from . import device_name, tool_device

N = 1 << 25
P = int(N * 16.2) | 1          # 600M-class: C = 8192, same as p=600000001
ITERS = 48


def variants():
    from ..ops.fourstep import Pipeline
    return {"lanecarry": Pipeline(), "hybrid": Pipeline(xla_carry=True)}


def build(p: int, n: int, pipe, device):
    """(engine, info): a FourStepEngine at (p, n) on pipe, and what its
    kernel plan runs."""
    from ..core.plan import cached_plan
    from ..engine.fourstep_engine import FourStepEngine
    from ..ops import fourstep as tfs
    t0 = time.perf_counter()
    eng = FourStepEngine(p, 2, plan=cached_plan(p, n), device=device,
                         pipe=pipe)
    fp = eng.t.fp
    return eng, {"p": p, "n": n, "C": fp.C,
                 "carry_tiles": tfs.carry_tiles(fp),
                 "xla_carry": tfs.use_xla_carry(fp),
                 "rowcarry": tfs.use_rowcarry(fp),
                 "setup_s": time.perf_counter() - t0}


def cases(eng) -> dict:
    """Each case's agreement with big-int (see the module docstring)."""
    mp = (1 << eng.p) - 1
    want = 3
    for a in (1, 3, 1):
        want = want * want * a % mp
    dense = 25 * 7          # (M_p - 5)^2 * 7 = (-5)^2 * 7 mod M_p
    out = {}
    eng.set(0, 3)
    eng.square_mul_seq(0, [1, 3, 1])
    out["chain"] = eng.get_int(0) == want
    eng.set(1, mp - 5)
    eng.square_mul(1, 7)
    out["wrap"] = eng.get_int(1) == dense
    eng.set(1, mp - 5)
    out["roundtrip"] = eng.get_int(1) == mp - 5
    eng.set(1, 5)
    eng.square_mul(1, 7)
    out["sq_small"] = eng.get_int(1) == 25 * 7
    eng.set(1, mp - 5)
    eng.square_mul_seq(1, [7])
    out["seq_dense"] = eng.get_int(1) == dense
    return out


def rate(eng, iters: int) -> float:
    """iter/s of a chain of iters squarings, warmed at that length."""
    eng.set(0, 3)
    eng.square_mul_seq(0, [1] * iters)
    eng.sync()
    t0 = time.perf_counter()
    eng.square_mul_seq(0, [1] * iters)
    eng.sync()
    return iters / (time.perf_counter() - t0)


def run(p: int, n: int, device, pipes: dict | None = None,
        iters: int = ITERS) -> dict:
    """Both variants at (p, n) (pipes: their pipelines, variants() by
    default): their info, cases and rate."""
    out = {}
    engines = {}
    for name, pipe in (pipes or variants()).items():
        eng, info = build(p, n, pipe, device)
        info["cases"] = cases(eng)
        info["bitexact"] = all(info["cases"].values())
        engines[name], out[name] = eng, info
    turns = {name: [] for name in engines}
    for name in ("lanecarry", "hybrid", "hybrid", "lanecarry"):
        turns[name].append(rate(engines[name], iters))
    for name, ips in turns.items():
        out[name]["ips"] = sum(ips) / len(ips)
        out[name]["turns"] = ips
    return out


def main(argv=None) -> int:
    dev = tool_device()
    out = run(P, N, dev)
    for name, info in out.items():
        print("RESULT " + json.dumps({"variant": name, **info}), flush=True)
    lc, hy = out["lanecarry"]["ips"], out["hybrid"]["ips"]
    print(f"lane-tiled {lc:.2f} iter/s vs hybrid {hy:.2f} iter/s "
          f"({lc / hy:.2f}x)", flush=True)
    ok = all(info["bitexact"] for info in out.values())
    print(json.dumps({"tool": "lanecarry_check", "card": device_name(dev),
                      "variants": out, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
