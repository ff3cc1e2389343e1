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
the same inputs, after canon.
"""

from __future__ import annotations

import json
import sys

from . import (OPS_PER_M31_PRODUCT, OPS_PER_PRODUCT, Timed, bound,
               check, device_ms, require_card)
from ..bench import card
from .microbench import SLOPE, slope

SHAPE = (256, 1024)
REPS = 64
# base products per rep (the bound's operations): gl64 one product; M31
# schoolbook 4 (sqr 2) of 32 x 32 bits; M61 Karatsuba 3 (sqr 2) of 64 x 64
PRODUCTS = {"gl_mul": (1, OPS_PER_PRODUCT), "gl_sqr": (1, OPS_PER_PRODUCT),
            "m31_mul": (4, OPS_PER_M31_PRODUCT),
            "m31_sqr": (2, OPS_PER_M31_PRODUCT),
            "m61_mul": (3, OPS_PER_PRODUCT), "m61_sqr": (2, OPS_PER_PRODUCT)}


def measure(reps: int = 10):
    """Each field op: (the Timed at 64 reps, {op: slope})."""
    from ..ops import probes as pr
    dev = require_card()
    n_el = SHAPE[0] * SHAPE[1]
    entries, per = [], {}
    for op in pr.FIELD_OPS:
        x = pr.rep_inputs(op, SHAPE, seed=7, device=dev)
        k, ops = PRODUCTS[op]
        planes = x.shape[0]
        b = bound(n_el * REPS * k * ops, 8 * planes * n_el)
        ms, got = device_ms(lambda: pr.fields(op, x, REPS), reps)
        ms_long, _ = device_ms(lambda: pr.fields(op, x, SLOPE * REPS), 3)
        per[op] = slope(ms, ms_long, REPS, n_el)
        entries.append(Timed(
            "probe_fields", f"{op} {SHAPE} x{REPS}", ms, b[0], b[1], got,
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
