"""The shape probes on the card: the twin of tools/exp_mosaic_shapes.py
and tools/exp_mosaic_shapes2.py.

`python -m prmers_tpu_torch.tools.probe_shapes` runs cases a-n
(ops/probes.SHAPE_CASES: merges, splits, concats, row and lane slices,
per-slice stores, u8 -> i8, and the int8 dots) through probe_shapes
(csrc/probe_shapes.cu) on seeded inputs, prints "<case> <what>: OK" for
each case whose kernel output equals its plain version bit for bit, and
one JSON line with the card's name and power limit and each case's ms and
bound (the dots' operations at the int8 peak, the copies' bytes), and the
empty launch's time (tools.empty_launch_ms, the floor of the method). A
case that differs fails the run. Beside every case it times one PyTorch
call that computes the same result on the same inputs, into an output
allocated before the timing as the kernel's is (LIBRARY; no kernel of the
port calls them), each pair of either from a cold L2 (tools.l2_flush),
as the bytes bound assumes: torch._int_mm for the dots b, e and n (n's
product alone, without its nine-slice sum), a copy, concatenation, sum
or add for the others.
"""

from __future__ import annotations

import json
import sys

from . import (PairTimes, Timed, bound, check, device_ms, empty_launch_ms,
               l2_flush, nbytes, require_card)
from ..bench import card


def _library(case: str, xs, out):
    """A thunk of the case's one-call PyTorch twin on its inputs into out
    (library_out; any operand reshaping done here, outside the timing)."""
    import torch
    x = xs[0]
    if case in ("b", "e", "n"):
        w, x = xs
        xt, wt = x.reshape(x.shape[0], -1).t().contiguous(), w.t()
        return lambda: torch._int_mm(xt, wt, out=out)
    view = {"a": lambda: x.reshape(out.shape),
            "d": lambda: x.reshape(out.shape), "f": lambda: x,
            "h": lambda: x[64:128], "i": lambda: x[:, 128:256],
            "l": lambda: x[:, 0:1, :],
            "m": lambda: x.reshape(1, 64, 1024).expand(8, 64, 1024)}
    if case in view:
        src = view[case]()
        o = out.view(8, 64, 1024) if case == "m" else out
        return lambda: o.copy_(src)
    return {
        "c": lambda: torch.cat([x] * 8, dim=0, out=out),
        "g": lambda: torch.cat([x] * 8, dim=1, out=out),
        "j": lambda: torch.sum(x[:, :8, :], dim=1, dtype=torch.int32,
                               out=out),
        "k": lambda: torch.add(x, 1, out=out),
    }[case]


def library_out(case: str, xs):
    """An output for the case's twin: the kernel's, or for the dots the
    transposed product's (N, M) int32."""
    import torch

    from ..ops import probes as pr
    if case in ("b", "e", "n"):
        w, x = xs
        return torch.empty((x.numel() // x.shape[0], w.shape[0]),
                           dtype=torch.int32, device=w.device)
    return pr.shape_out(case, xs[0].device)


def measure(reps: int = 16):
    """Every case: (the list of Timed, {case: its library call's pair
    times}), both timed alike (device_ms, outputs allocated before the
    first pair) in turns, kernel, twin, twin, kernel, reps pairs a turn;
    each pair from a cold L2; each library result but n's (its product
    only) held equal to the kernel's."""
    import torch

    from ..ops import probes as pr
    dev = require_card()
    flush = l2_flush(dev)
    entries, library = [], {}
    for case, (_ins, what) in pr.SHAPE_CASES.items():
        xs = pr.shape_inputs(case, device=dev)
        out = pr.shape_out(case, dev)
        fns = {"kernel": lambda: pr.shape_case(case, *xs, out=out),
               "twin": _library(case, xs, library_out(case, xs))}
        pairs, res = {"kernel": (), "twin": ()}, {}
        for who in ("kernel", "twin", "twin", "kernel"):
            t, res[who] = device_ms(fns[who], reps, flush)
            pairs[who] += t.pairs
        t, got = PairTimes(pairs["kernel"]), res["kernel"]
        library[case], same = PairTimes(pairs["twin"]), res["twin"]
        if case in ("b", "e", "n"):
            w, x = xs
            b = bound(2 * w.shape[0] * x.numel(), nbytes(*xs, got))
        else:
            b = bound(0, nbytes(*xs, got))
        if case in ("b", "e"):
            same = same.t()
        if case != "n" and not torch.equal(same.reshape(got.shape), got):
            raise AssertionError(f"case {case}: the library call computes "
                                 "another result")
        entries.append(Timed("probe_shapes", f"{case} {what}", t, b[0],
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
                      "library": {k: v.row() for k, v in library.items()},
                      "empty_launch": empty_launch_ms().row()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
