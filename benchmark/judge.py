"""The comparison that decides `correct`.

What the window's squarings and block multiplies left in the PRP driver's
registers, against the plain reference (reference.prp_state) at the same
number of iterations:

  r0_words_off       64-bit words of the residue R0 that differ
  r1_words_off       64-bit words of the Gerbicz-Li accumulator R1
  gl_checks_failed   Gerbicz-Li checks of run_prp_or_ll that failed: on
                     exact residues every check holds, so the
                     reference's verdict is always "passed"

All three are exact comparisons: the limit is 0. The control (the
reference in float32 in the program's place, control.py) reads thousands
of words off in both registers (PERF.md gives the readings).
"""

from __future__ import annotations

from .reference import pack, words_off

LIMITS = {"r0_words_off": 0, "r1_words_off": 0, "gl_checks_failed": 0}


def to_int(digits, widths, p: int) -> int:
    return pack(digits, widths) % ((1 << p) - 1)


def compare(p: int, prog: dict, widths, r0: int, r1: int,
            outcome: dict) -> dict:
    """Each compared number beside its limit. `prog` holds the program's
    digit vectors of R0 and R1 (its widths beside them)."""
    values = {"r0_words_off": words_off(to_int(prog["r0"], widths, p), r0, p),
              "r1_words_off": words_off(to_int(prog["r1"], widths, p), r1, p),
              "gl_checks_failed": outcome["failed"]}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
