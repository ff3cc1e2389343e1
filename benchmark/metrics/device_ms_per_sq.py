"""Device time (torch.profiler: kernels and copies, their union) over the
traced window, in ms a squaring, the checks' replays among the squarings.
Layer: kernels (csrc/)."""


def read(ctx):
    tr, sq = ctx["trace"], ctx["squarings"]["all"]
    if not tr or not sq or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] * 1e3 / sq
