"""Rates of the card's matrix and integer units: the twin of
tools/microbench3.py.

`python -m prmers_tpu_torch.tools.microbench` prints one JSON line with
the card's name and power limit and:

  * int8 and bf16 matrix products chained 16 deep (each product's result
    cut back to the next one's input, so none can be skipped), at the
    TPU tool's shapes: TOP/s and TFLOP/s. These are library calls
    (torch._int_mm, torch.matmul), as the TPU tool's were XLA dots outside
    any Pallas kernel; no kernel of the port calls them;
  * probe_vpu (csrc/probe_reps.cu, the twin of microbench3.py:77): y = y *
    x + 1 on (512, 1024) int32 words, 256 reps, a mul and an add each;
  * probe_mulmod (the twin of microbench3.py:152): a = a * b mod P on
    (512, 1024) gl64 values, 256 reps.

Each probe is timed at the TPU tool's reps (its `ms` and bound) and, for
its rate, at 16 times the reps: the slope between the two takes out the
launch and the memory traffic. Each is held against its plain version on
the same inputs after its timed run.
"""

from __future__ import annotations

import json
import sys

from . import (FP32_OPS_PER_S, OPS_PER_PRODUCT, Timed, bound,
               check, device_ms, require_card, stream_ms)
from ..bench import card

SHAPE = (512, 1024)
REPS = 256
SLOPE = 16          # the rate's second run takes SLOPE * REPS reps
MM_DEPTH = 16
INT8_MM = ((128, 128, 65536), (512, 512, 16384), (256, 256, 32768))
BF16_MM = ((128, 128, 65536), (512, 512, 16384))


def matmul_rates(dev) -> list[dict]:
    """The serial library products: ms per product and its rate."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(0)
    out = []
    for kind, shapes in (("int8", INT8_MM), ("bf16", BF16_MM)):
        for M, K, B in shapes:
            if kind == "int8":
                # transposed, x^T (B, K) @ w^T: the row-major by
                # column-major operands cuBLAS's int8 product takes
                w = torch.randint(-128, 128, (M, K), generator=g,
                                  dtype=torch.int8).to(dev)
                x0 = torch.randint(-128, 128, (B, K), generator=g,
                                   dtype=torch.int8).to(dev)

                def chain(w=w, x0=x0, K=K):
                    x = x0
                    for _ in range(MM_DEPTH):
                        x = (torch._int_mm(x, w.t()) & 127).to(
                            torch.int8)[:, :K]
                    return x
            else:
                w = torch.randn((M, K), generator=g).to(torch.bfloat16) \
                    .to(dev)
                x0 = torch.randn((K, B), generator=g).to(torch.bfloat16) \
                    .to(dev)

                def chain(w=w, x0=x0, K=K):
                    x = x0
                    for _ in range(MM_DEPTH):
                        x = (torch.matmul(w, x) * 1e-3)[:K]
                    return x
            ms = stream_ms(chain, 3) / MM_DEPTH
            out.append({"kind": kind, "shape": [M, K, B], "ms": ms,
                        "rate_T": 2 * M * K * B / (ms * 1e-3) / 1e12})
    return out


def slope(ms: float, ms_long: float, reps: int, n_el: int) -> dict:
    """The per-element cost of one rep from two runs of reps and SLOPE *
    reps: ns per rep and element, and its rate in G per second."""
    per = (ms_long - ms) * 1e-3 / ((SLOPE - 1) * reps * n_el)
    return {"ms_reps": ms, f"ms_{SLOPE}x_reps": ms_long,
            "ns_per_el": per * 1e9,
            "rate_G_per_s": 1 / per / 1e9 if per > 0 else None}


def measure(reps: int = 10):
    """The two probes: (the Timed at the TPU tool's reps, the rates from
    the slope)."""
    import torch

    from ..ops import gl64 as gl
    from ..ops import probes as pr
    dev = require_card()
    n_el = SHAPE[0] * SHAPE[1]
    x = pr.rep_inputs("vpu", SHAPE, seed=0, device=dev)[0].contiguous()
    ab = pr.rep_inputs("gl_mul", SHAPE, seed=1, device=dev)
    entries, rates = [], {}
    for name, fn_k, plain, norm, b in (
            ("probe_vpu", lambda k: pr.vpu(x, k),
             lambda: pr.reps_plain("vpu", x.unsqueeze(0), REPS)[0], None,
             bound(2 * n_el * REPS, 8 * n_el, FP32_OPS_PER_S)),
            ("probe_mulmod", lambda k: pr.mulmod(ab, k),
             lambda: pr.reps_plain("gl_mul", ab, REPS)[:2],
             lambda v: torch.stack(gl.canon(*pr.words(v))),
             bound(n_el * REPS * OPS_PER_PRODUCT, 24 * n_el))):
        ms, got = device_ms(lambda: fn_k(REPS), reps)
        ms_long, _ = device_ms(lambda: fn_k(SLOPE * REPS), 3)
        rates[name] = slope(ms, ms_long, REPS, n_el)
        entries.append(Timed(name, f"{SHAPE} x{REPS}", ms, b[0], b[1], got,
                             plain, norm))
    return entries, rates


def main(argv=None) -> int:
    dev = require_card()
    mm = matmul_rates(dev)
    entries, rates = measure()
    check(entries)
    print(json.dumps({"tool": "microbench", "card": card(),
                      "matmul_library": mm, "probes": [e.row()
                                                       for e in entries],
                      "rates": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
