"""The roofline's yardstick, frozen here so that no change to the port can
move it: the card's peaks, a squaring's least work counted from the
plan's shapes, and the idle arithmetic. Nothing here imports the port.

Sources, copied and not imported:
  * HBM 3.35 TB/s: NVIDIA's H100 SXM data sheet (prmers_tpu_torch/tools/
    __init__.py HBM_BYTES_PER_S).
  * The integer pipes (prmers_tpu_torch/tools/sass.py,
    tools/__init__.py INT_LANES_PER_SM): Hopper's SM has two integer
    pipes of 64 lanes; IMAD in all its forms runs on the FMA pipe, an
    IMAD.WIDE (a 64-bit result) in two slots. A gl64 (Goldilocks, P =
    2^64 - 2^32 + 1) product of two 64-bit words is four IMAD.WIDE, 8
    FMA-pipe slots (sass.PRODUCT_SLOTS["gl_mul"]); its adds and folds run
    on the ALU pipe beside it and are not counted.
  * The products a digit (PERF.md section 3; tools/profile_passes.py
    axis_bound and span_bound, ops/fourstep.py c_fft_products and
    r2_split_products, the kernels' comments): the fewest mod-P products
    a squaring's function needs on the four-step plan (R1, R2, C), a
    shift butterfly level counted as half a product. 32 at (64, 64,
    2048), 32.975 at (64, 320, 1024).
  * Idle = 1 - device busy / wall over a traced stretch
    (prmers_tpu_torch/profile.py).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT_LANES_PER_SM = 64
FMA_SLOTS_PER_PRODUCT = 8


def r2_split_products(l2: int) -> float:
    """Products a digit of one radix-5 r2 DFT at L2 = 5 * M as a 5 x M
    split: 16 per 5-point DFT of 5 digits and 4 twiddles per j2 > 0."""
    m = l2 // 5
    return (16 * m + 4 * (m - 1)) / l2


def products_per_digit(r1: int, r2: int, c: int) -> float:
    """A squaring's least mod-P products a digit on the plan (R1, R2, C):

      r1 DFT          log2(R1) / 2, and x k1_cs, x k1_rs      (K1)
      r2 DFT          log2(R2) / 2 or the radix-5 split, each way
      scales          x mf, x mi, x t_r_inv
      C-transform     1 + log2(C) / 2 each way (factored)
      square          1
      r1 inverse      log2(R1) / 2, and x k3_rs                (K3)
    """
    if r2 & (r2 - 1) == 0:
        r2_dft = math.log2(r2) / 2 if r2 > 1 else 0.0
    else:
        r2_dft = r2_split_products(r2)
    r1_dft = math.log2(r1) / 2
    return ((2 + r1_dft) + 2 * r2_dft + 3 + 2 * (1 + math.log2(c) / 2) + 1
            + (1 + r1_dft))


def least_ms_per_squaring(plan: dict, sms: int, sm_clock_hz: float
                          ) -> tuple[float, str]:
    """(ms, what binds): the larger of a squaring's products on the FMA
    pipe and its bytes over HBM. Bytes: the register's digits and its
    carries (one a carry unit, R1 * R2 * T) read once and written once,
    8 bytes each."""
    r1, r2, c = plan["R1"], plan["R2"], plan["C"]
    n = r1 * r2 * c
    ops_s = (products_per_digit(r1, r2, c) * n * FMA_SLOTS_PER_PRODUCT
             / (sms * INT_LANES_PER_SM * sm_clock_hz))
    bytes_s = 2 * 8 * (n + r1 * r2 * plan.get("T", 1)) / HBM_BYTES_PER_S
    return (ops_s * 1e3, "operations") if ops_s >= bytes_s else \
        (bytes_s * 1e3, "bytes")


def idle_share(busy_s: float, wall_s: float) -> float:
    return 1.0 - busy_s / wall_s
