"""Kernel-wrapper calls of the port (ops/kernels.calls: one a call,
however many grid launches it takes) over the window's squarings, the
checks' replays among them. Layer: kernel wrappers (ops/kernels.py)."""


def read(ctx):
    sq = ctx["squarings"]["all"]
    if not sq or not ctx["calls"]:
        return None
    return sum(ctx["calls"].values()) / sq
