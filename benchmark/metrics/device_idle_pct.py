"""The device's idle share of the traced window, 1 - busy / wall
(yardstick.idle_share), in %. Layer: device."""

from .. import yardstick


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * yardstick.idle_share(tr["busy_s"], tr["window_s"])
