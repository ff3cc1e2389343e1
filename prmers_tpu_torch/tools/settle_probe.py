"""Device probe: carry_full's time against its input (random digits, and
one carry rippling through saturated all-ones digits), with the
data-dependent loop and with static rounds.

Twin of the JAX package's tools/settle_probe.py, which timed the XLA
`carry_full` (its while_loop) to test it as the cause of a worker crash at
n = 2^25. The port's `ops/carry.carry_full` runs its absorb rounds while
any carry exceeds 1, one host sync a round, then a lookahead scan for the
0/1 carries; with `rounds=` it runs that many rounds and no loop, as the
any-size engine's CUDA graphs call it. Usage:

    python -m prmers_tpu_torch.tools.settle_probe [case ...]

Cases: random (n = 2^25, widths 16 and 17, values below 2^62) |
allones_small_n (2^20) | allones (2^25): every digit at its mask and one
carry at digit 0, which ripples around the whole ring.

Changes from the JAX tool: each case runs both forms, `loop` (rounds=None)
and `static` (rounds = absorb_rounds of the input's largest value and the
narrowest width, as the graphs take it), each timed by CUDA events (the
median of `reps` pairs, behind a device sleep; the loop's host syncs
inside its time) and with the absorb rounds it took (the loop's counted
by replaying its rounds). Each output is held to the exact digits: for
random, carry_full_np (the reference's numpy loop); for the all-ones
cases, the digits of the value mod 2^p - 1 from big-int, which are
carry_full_np's answer (its loop would run one round per digit there, n
rounds; tests/test_torch_devtools.py holds all three cases to
carry_full_np itself at n = 2^12). Prints a row a form, then one JSON
line; exit 1 on any difference. Runs on the card, or on the CPU under
PRMERS_PLATFORM=cpu.
"""

from __future__ import annotations

import json
import sys
import types

import numpy as np

from . import device_name, device_ms, tool_device

CASES = ("random", "allones_small_n", "allones")
SIZES = {"random": 1 << 25, "allones_small_n": 1 << 20, "allones": 1 << 25}


def case_input(case: str, n: int | None = None):
    """(y, widths) of a case as the JAX tool makes them (u64, u8)."""
    n = n or SIZES[case]
    widths = np.full(n, 16, np.uint8)
    if case == "random":
        widths[::3] = 17
        y = np.random.default_rng(0).integers(0, 1 << 62, n,
                                              dtype=np.uint64)
    elif case in ("allones", "allones_small_n"):
        y = (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
        y[0] += np.uint64(1)   # one carry at digit 0 -> full-ring ripple
    else:
        raise ValueError(f"unknown case {case!r}")
    return y, widths


def expected(case: str, y: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """The normalized digits of y (see the module docstring)."""
    from ..ops.carry import carry_full_np
    from ..utils import digits as dg
    if case == "random":
        return carry_full_np(types.SimpleNamespace(xp=np), y, widths, None)
    mp = (1 << int(widths.astype(np.int64).sum())) - 1
    return dg.int_to_digits(dg.digits_to_int(y, widths) % mp, widths)


def loop_rounds(y, widths) -> int:
    """The absorb rounds carry_full's loop takes on y (the first
    included): its rounds replayed."""
    import torch

    from ..ops import carry
    w = widths.to(torch.int64)
    m = (1 << w) - 1
    c, d = carry.first_round(y, w, m)
    rounds = 1
    while bool((c > 1).any()):
        t = d + torch.roll(c, 1, -1)
        c, d = t >> w, t & m
        rounds += 1
    return rounds


def probe(case: str, device, n: int | None = None, reps: int = 5) -> list:
    """The case's two rows (loop, static) on device."""
    import torch

    from ..ops import carry
    from ..ops import gl64 as gl
    y, widths = case_input(case, n)
    want = expected(case, y, widths)
    yt = gl.from_numpy_u64(y, device)
    wt = torch.from_numpy(widths.astype(np.int64)).to(device)
    static = carry.absorb_rounds(int(y.max()) + 1, int(widths.min()))
    rows = []
    for form, rounds in (("loop", None), ("static", static)):
        def run(rounds=rounds):
            return carry.carry_full(yt, wt, rounds=rounds)
        if device.type == "cuda":
            times, got = device_ms(run, reps)
            timing = times.row()
        else:
            got = run()
            timing = {"median_ms": None}   # no device time on the CPU
        equal = bool(np.array_equal(gl.to_numpy_u64(got), want))
        rows.append({"case": case, "n": len(y), "form": form,
                     "rounds": loop_rounds(yt, wt) if rounds is None
                     else rounds, "equal": equal, **timing})
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cases = argv or list(CASES)
    dev = tool_device()
    rows = []
    for case in cases:
        for r in probe(case, dev):
            ms = "not measured" if r["median_ms"] is None else \
                f"{r['median_ms']:.3f} ms"
            print(f"{case}: n=2^{r['n'].bit_length() - 1} {r['form']:6s} "
                  f"rounds={r['rounds']} {ms} "
                  f"{'equal' if r['equal'] else 'DIFFERS'}", flush=True)
            rows.append(r)
    ok = all(r["equal"] for r in rows)
    print(json.dumps({"tool": "settle_probe", "card": device_name(dev),
                      "rows": rows, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
