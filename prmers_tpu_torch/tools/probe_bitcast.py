"""The byte order of a u32 -> int8 bitcast on the card: the twin of
tools/probe_bitcast.py.

`python -m prmers_tpu_torch.tools.probe_bitcast` fills an (8, 128) u32
array whose word l holds the byte l * 4 + b at byte b, turns it into (32,
128) int8 with probe_bitcast (csrc/probe_bitcast.cu: row 4l + b takes byte
b of word l as the card stores it), holds that against the plain version,
and prints the first column, the order's name ("interleaved": word-major,
"plane-major", or "other") and one JSON line with the card's name and
power limit, with the empty launch's time beside its own (the floor of
the timing method).
"""

from __future__ import annotations

import json
import sys

from . import (Timed, bound, check, device_ms, empty_launch_ms,
               require_card)
from ..bench import card


def measure(reps: int = 10):
    """(the Timed, the order's name, the output's first column)."""
    import torch

    from ..ops import probes as pr
    dev = require_card()
    x = torch.from_numpy(pr.bitcast_pattern().view("int32")).to(dev)
    out = torch.empty((32, 128), dtype=torch.int8, device=dev)
    t, got = device_ms(lambda: pr.bitcast(x, out=out), reps)
    b = bound(0, 2 * x.numel() * 4)
    col = got[:, 0].tolist()
    return (Timed("probe_bitcast", "(8, 128) u32 -> (32, 128) int8", t,
                  b[0], b[1], got, lambda: pr.bitcast_plain(x)),
            pr.bitcast_order(col), col)


def main(argv=None) -> int:
    entry, order, col = measure()
    check([entry])
    print("row -> (word*4+byte):", col)
    print(f"ORDER: {order}")
    print(json.dumps({"tool": "probe_bitcast", "card": card(),
                      "order": order, "probe": entry.row(),
                      "empty_launch": empty_launch_ms().row()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
