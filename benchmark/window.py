"""The measured window: the harness's hooks on the engine that the PRP
driver runs.

They shadow the engine instance's square_mul_seq and get_int (and, in a
traced run, mul, set_multiplicand and copy), so that the harness

  * counts the squarings each register gets, from the calls it passes
    on: the test's on R0 and the Gerbicz-Li check's replays on R3;
  * opens the window at the PRP driver's first test squaring (its preamble,
    three set_int of p-bit values on the host, 4 s at 2^23 and 12 s at
    5 * 2^22, is set-up a test pays once), with the device synchronized;
  * closes the window: once its seconds have passed, before the next
    slice of STEP squarings or the next get_int, it synchronizes the
    device, takes the time and raises WindowClosed into the PRP driver. A
    Gerbicz-Li block (11,673 squarings at p = 136279841, 18,226 at
    332192831) is cut where it stands, not waited for, and the PRP driver
    does not catch WindowClosed: its KeyboardInterrupt path would write
    a checkpoint of all eight registers (0.5 GB at 2^23, 1.3 GB at
    5 * 2^22) into every run;
  * keeps a span of each call in memory (name, host start and end), and
    in a traced run opens a profiler span ("bench:<name>",
    torch.profiler.record_function) over each call and one over each
    Gerbicz-Li check, from its first replay squaring to the end of its
    get_int of R1.

A square_mul_seq call is passed on in slices of STEP squarings. The
engine runs one step a squaring at every size a cell runs (n >= 2^20),
so the kernels launched are the same either way; where it runs K9 (n =
2^15 ... 2^19, no cell) a slice is one K9 launch of STEP squarings in
place of the engine's 512.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import nullcontext

R0, R1, R3 = 0, 1, 3     # modes/prp_ll.py: residue, accumulator, replay
STEP = 64                # squarings a slice: how far past its time a window runs


class WindowClosed(BaseException):
    """Raised through the PRP driver when the window's time is up."""


class Window:
    def __init__(self, eng, seconds: float, sync, traced: bool = False,
                 on_open=None):
        self.eng = eng
        self.on_open = on_open
        self.seconds = seconds
        self.sync = sync
        self.traced = traced
        self.squarings: dict[int, int] = defaultdict(int)
        self.spans: list[tuple[str, float, float]] = []
        self.t0 = self.t_end = self.deadline = None
        self._check = self._window = None
        self._names = []

    # -- hooks --------------------------------------------------------------
    def install(self) -> None:
        eng = self.eng
        self._square_mul_seq = eng.square_mul_seq
        self._get_int = eng.get_int
        eng.square_mul_seq = self.square_mul_seq
        eng.get_int = self.get_int
        self._names = ["square_mul_seq", "get_int"]
        if self.traced:
            for name in ("mul", "set_multiplicand", "copy"):
                setattr(eng, name, self._spanned(name, getattr(eng, name)))
                self._names.append(name)

    def uninstall(self) -> None:
        for name in self._names:
            self.eng.__dict__.pop(name, None)
        self._names = []

    def span(self, name: str):
        if not self.traced:
            return nullcontext()
        from torch.profiler import record_function
        return record_function("bench:" + name)

    def _spanned(self, name, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                with self.span(name):
                    return fn(*args, **kw)
            finally:
                self.spans.append((name, t, time.perf_counter()))
        return call

    def square_mul_seq(self, src, a_vec):
        if self.t0 is None and src == R0:
            self.open()
        a = list(a_vec)
        name = f"square_mul_seq(R{src})"
        if src == R3 and self.traced and self._check is None:
            from torch.profiler import record_function
            self._check = record_function("bench:gl_check")
            self._check.__enter__()
        t = time.perf_counter()
        try:
            with self.span(name):
                for i in range(0, len(a), STEP):
                    self.due()
                    part = a[i:i + STEP]
                    self._square_mul_seq(src, part)
                    self.squarings[src] += len(part)
        finally:
            self.spans.append((name, t, time.perf_counter()))

    def get_int(self, src):
        self.due()
        name = f"get_int(R{src})"
        t = time.perf_counter()
        try:
            with self.span(name):
                return self._get_int(src)
        finally:
            self.spans.append((name, t, time.perf_counter()))
            if src == R1 and self._check is not None:
                self._check.__exit__(None, None, None)
                self._check = None

    # -- the window ---------------------------------------------------------
    def open(self) -> None:
        self.sync()
        if self.on_open is not None:
            self.on_open()
        if self.traced:
            from torch.profiler import record_function
            self._window = record_function("bench:window")
            self._window.__enter__()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds

    def due(self) -> None:
        if self.t0 is not None and self.t_end is None and \
                time.perf_counter() >= self.deadline:
            self.close()
            raise WindowClosed

    def close(self) -> None:
        """End the window: everything enqueued has run on the device."""
        if self.t_end is None:
            self.sync()
            self.t_end = time.perf_counter()

    def finish(self) -> None:
        """After the PRP driver has returned: end the span of a check the
        window cut (a complete check's span holds its get_int of R1), and
        the window's span."""
        for rf in (self._check, self._window):
            if rf is not None:
                rf.__exit__(None, None, None)
        self._check = self._window = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0
