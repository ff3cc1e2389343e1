"""A squaring's least time (yardstick.least_ms_per_squaring: its products
on the FMA pipe or its bytes over HBM, whichever binds, from the
configuration's plan) over device_ms_per_sq, in %. Layer: kernels."""

from .. import yardstick
from . import device_ms_per_sq


def read(ctx):
    ms = device_ms_per_sq.read(ctx)
    card = ctx["card"]
    if ms is None or not card:
        return None
    least, _ = yardstick.least_ms_per_squaring(ctx["plan"], card["sms"],
                                               card["sm_clock_hz"])
    return 100.0 * least / ms
