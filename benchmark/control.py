"""The control of the comparison: the plain reference computed one
precision below (float32 in place of float64), put in the program's
place and judged by judge.compare against the float64 reference, at the
cell's own exponent and transform length, over the first Gerbicz-Li
block and a share of the next (so R1 holds a boundary's product). Its
words off are the upper readings that the limits (0) sit below.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--device cuda]

prints one JSON line: for each seed p, the iterations, and each compared
number. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def readings(cell, seed: int, device: str, squarings: int = 0) -> dict:
    import numpy as np
    import torch

    from . import judge, reference, spec
    p = spec.exponent(cell.config, cell.traffic, seed)
    k = squarings or spec.first_block(p) + math.isqrt(p) // 8
    r0, r1, err = reference.prp_state(p, k, device)
    c0, c1, err32 = reference.prp_state(p, k, device, dtype=torch.float32)
    widths = np.diff(reference.digit_positions(
        p, reference.transform_length(p)))
    # the control's values as digit vectors, as a program's are read
    prog = {"r0": reference.unpack(c0, widths),
            "r1": reference.unpack(c1, widths)}
    checks = judge.compare(p, prog, widths, r0, r1,
                           {"failed": 0, "rolled_back": 0})
    return {"seed": seed, "p": p, "squarings": k,
            "rounding_error": err, "control_rounding_error": err32,
            "check": {k2: v["value"] for k2, v in checks.items()},
            "correct": judge.correct(checks)}


def main(argv=None) -> int:
    from . import spec
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--squarings", type=int, default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    rows = [readings(cell, int(s), args.device, args.squarings)
            for s in args.seeds.split(",")]
    print(json.dumps({"workload": args.workload, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
