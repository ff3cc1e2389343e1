"""The shape probes on the card: the twin of tools/exp_mosaic_shapes.py
and tools/exp_mosaic_shapes2.py.

`python -m prmers_tpu_torch.tools.probe_shapes` runs cases a-n
(ops/probes.SHAPE_CASES: merges, splits, concats, row and lane slices,
per-slice stores, u8 -> i8, and the int8 dots) through probe_shapes
(csrc/probe_shapes.cu) on seeded inputs, prints "<case> <what>: OK" for
each case whose kernel output equals its plain version bit for bit, and
one JSON line with the card's name and power limit and each case's ms and
bound (the dots' operations at the int8 peak, the copies' bytes). A case
that differs fails the run. Beside every case it times one PyTorch call
that computes the same result on the same inputs (LIBRARY; no kernel of
the port calls them): torch._int_mm for the dots b, e and n (n's product
alone, without its nine-slice sum), a copy, concatenation, slice, sum or
add for the others.
"""

from __future__ import annotations

import json
import sys

from . import Timed, bound, check, device_ms, nbytes, require_card
from ..bench import card


def _library(case: str, xs):
    """A thunk of the case's one-call PyTorch twin on its inputs (any
    operand reshaping done here, outside the timing)."""
    import torch
    x = xs[0]
    if case in ("b", "e", "n"):
        w, x = xs
        xt = x.reshape(x.shape[0], -1).t().contiguous()
        wt = w.t()
        return lambda: torch._int_mm(xt, wt)
    return {
        "a": lambda: x.clone(),
        "c": lambda: torch.cat([x] * 8, dim=0),
        "d": lambda: x.clone(),
        "f": lambda: x.to(torch.int8),
        "g": lambda: torch.cat([x] * 8, dim=1),
        "h": lambda: x[64:128].clone(),
        "i": lambda: x[:, 128:256].contiguous(),
        "j": lambda: x[:, :8, :].sum(dim=1, dtype=torch.int32),
        "k": lambda: x + 1,
        "l": lambda: x[:, 0:1, :].contiguous(),
        "m": lambda: x.reshape(64, 1024).repeat(8, 1),
    }[case]


def measure(reps: int = 10):
    """Every case: (the list of Timed, {case: its library call's ms}),
    both timed alike (device_ms); each library result but n's (its
    product only) held equal to the kernel's."""
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
        else:
            b = bound(0, nbytes(*xs, got))
        lib = _library(case, xs)
        library[case], same = device_ms(lib, reps)
        if case in ("b", "e"):
            same = same.t()
        if case != "n" and not torch.equal(same.reshape(got.shape), got):
            raise AssertionError(f"case {case}: the library call computes "
                                 "another result")
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
                      "library_ms": library}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
