"""The shape probes on the card: the twin of tools/exp_mosaic_shapes.py
and tools/exp_mosaic_shapes2.py.

`python -m prmers_tpu_torch.tools.probe_shapes` runs cases a-n
(ops/probes.SHAPE_CASES: merges, splits, concats, row and lane slices,
per-slice stores, u8 -> i8, and the int8 dots) through probe_shapes
(csrc/probe_shapes.cu) on seeded inputs, prints "<case> <what>: OK" for
each case whose kernel output equals its plain version bit for bit, and
one JSON line with the card's name and power limit and each case's ms and
bound (the dots' operations at the int8 peak, the copies' bytes). A case
that differs fails the run. Beside the dots b and e it times
torch._int_mm on the same inputs, the library call for an int8 product
(no kernel of the port calls it).
"""

from __future__ import annotations

import json
import sys

from . import (Timed, bound, check, device_ms, nbytes, require_card,
               stream_ms)
from ..bench import card


def measure(reps: int = 10):
    """Every case: (the list of Timed, {case: torch._int_mm ms})."""
    import torch

    from ..ops import probes as pr
    dev = require_card()
    entries, library = [], {}
    for case, (_ins, what) in pr.SHAPE_CASES.items():
        xs = pr.shape_inputs(case, device=dev)
        ms, got = device_ms(lambda: pr.shape_case(case, *xs), reps)
        if case in ("b", "e", "n"):
            w, x = xs
            b = bound(2 * w.shape[0] * x.numel(), nbytes(*xs, got))
            if case != "n":
                xt = x.reshape(x.shape[0], -1).t().contiguous()
                library[case] = stream_ms(
                    lambda: torch._int_mm(xt, w.t()), reps)
        else:
            b = bound(0, nbytes(*xs, got))
        entries.append(Timed("probe_shapes", f"{case} {what}", ms, b[0],
                             b[1], got,
                             lambda case=case, xs=xs: pr.shape_plain(case,
                                                                     *xs)))
    return entries, library


def main(argv=None) -> int:
    entries, library = measure()
    check(entries)
    for e in entries:
        print(f"{e.what}: OK")
    print(json.dumps({"tool": "probe_shapes", "card": card(),
                      "cases": [e.row() for e in entries],
                      "int_mm_ms": library}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
