"""The per-element cost of each field's mul and sqr on the card: the twin
of tools/microbench_fields.py.

`python -m prmers_tpu_torch.tools.microbench_fields` runs probe_fields
(csrc/probe_reps.cu, the twin of microbench_fields.py:71's rep-loop
kernel) for gl64 mul / sqr (the Goldilocks path), GF(M31^2) complex mul /
sqr and GF(M61^2) complex mul / sqr (the two planes of fft3161), 64 reps
on (256, 1024) words as the TPU tool, and prints one JSON line with the
card's name and power limit, each op's ns per element from the slope
between 64 and 16 x 64 reps, and the fft3161 break-even ratios: one
fft3161 word (an M31 and an M61 complex op) carries about twice the
payload bits of a gl64 word, so fft3161 pays where

    ratio = (M31 op + M61 op) / (2 x gl64 op) < 1.

Each op is held against its plain version (ops/mers.py, ops/gl64.py) on
the same inputs, after canon. Each op's bound prices a rep at the
integer instructions of its compiled loop, as slots of the busier integer
pipe (tools/sass.py), over the pipe's rate, beside its bytes: the loop's
issue rate. Its products' slots alone (sass.PRODUCT_SLOTS) give a loose
floor of the function beside it.
"""

from __future__ import annotations

import json
import sys

from . import Timed, check, int_pipe_rate, require_card
from ..bench import card
from .microbench import rep_bound, rep_times

SHAPE = (256, 1024)
REPS = 64


def measure(reps: int = 10):
    """Each field op: (the Timed at 64 reps, {op: slope and bound})."""
    import torch

    from ..ops import probes as pr
    dev = require_card()
    n_el = SHAPE[0] * SHAPE[1]
    rate = int_pipe_rate()
    entries, per = [], {}
    for op in pr.FIELD_OPS:
        x = pr.rep_inputs(op, SHAPE, seed=7, device=dev)
        outs = [torch.empty_like(x) for _ in range(2)]
        t, got, per[op] = rep_times(
            lambda k, o, op=op, x=x: pr.fields(op, x, k, out=o), REPS, n_el,
            *outs, reps)
        priced, b = rep_bound(op, n_el, REPS, 8 * x.shape[0] * n_el, rate)
        per[op].update(priced)
        entries.append(Timed(
            "probe_fields", f"{op} {SHAPE} x{REPS}", t, b[0], b[1], got,
            lambda op=op, x=x: pr.reps_plain(op, x, REPS),
            lambda v, op=op: pr.canon_planes(op, v)))
    return entries, per


def ratios(per: dict) -> dict:
    """fft3161 word cost over two gl64 words, for mul and for sqr."""
    out = {}
    for kind in ("mul", "sqr"):
        w3161 = per[f"m31_{kind}"]["ns_per_el"] + \
            per[f"m61_{kind}"]["ns_per_el"]
        gl = per[f"gl_{kind}"]["ns_per_el"]
        out[kind] = {"fft3161_word_ns": w3161, "two_gl64_ns": 2 * gl,
                     "ratio": w3161 / (2 * gl)}
    return out


def main(argv=None) -> int:
    entries, per = measure()
    check(entries)
    print(json.dumps({"tool": "microbench_fields", "card": card(),
                      "ops": [e.row() for e in entries], "per_el": per,
                      "fft3161": ratios(per)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
