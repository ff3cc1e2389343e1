"""Progress display + run logging (reference: src/core/{Spinner,Logger}.cpp)."""

from __future__ import annotations

import sys
import time


class Progress:
    def __init__(self, total: int, label: str = "", interval: float = 10.0,
                 stream=None):
        self.total = total
        self.label = label
        self.interval = interval
        self.stream = stream or sys.stdout
        self.start_time = time.monotonic()
        self.last_display = 0.0
        self.window_start = (0, self.start_time)

    def maybe_display(self, done: int, res64: str = "") -> None:
        now = time.monotonic()
        if now - self.last_display < self.interval:
            return
        self.display(done, res64)

    def display(self, done: int, res64: str = "") -> None:
        now = time.monotonic()
        w_done, w_t = self.window_start
        dt = max(now - w_t, 1e-9)
        ips = (done - w_done) / dt
        eta = (self.total - done) / ips if ips > 0 else float("inf")
        pct = 100.0 * done / max(self.total, 1)
        msg = (f"{self.label} {done}/{self.total} ({pct:.2f}%) "
               f"{ips:.2f} iter/s ETA {_fmt_eta(eta)}")
        if res64:
            msg += f" res64={res64}"
        print(msg, file=self.stream, flush=True)
        self.last_display = now
        self.window_start = (done, now)

    def elapsed(self) -> float:
        return time.monotonic() - self.start_time


def _fmt_eta(seconds: float) -> str:
    if seconds == float("inf"):
        return "?"
    s = int(seconds)
    d, s = divmod(s, 86400)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    if d:
        return f"{d}d{h:02}:{m:02}:{s:02}"
    return f"{h:02}:{m:02}:{s:02}"
