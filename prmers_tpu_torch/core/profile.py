"""`-profile` support: per-op accounting + calibrated timing report.

The reference collects per-kernel execution times from an OpenCL profiling
queue and prints an aggregate map at exit (reference: include/marin/ocl.h
:238-310 `profile` struct + `-profile` flag, README.md:313). XLA dispatch
is asynchronous, so per-call wall clocks only measure enqueue cost; this
TPU redesign therefore combines
  * exact op COUNTS gathered during the run (free), with
  * a calibration pass at report time: each hot op is re-run a few times
    sync-bracketed to get honest ms/op at the run's transform size.

Port: a copy of prmers_tpu/core/profile.py. One change: ProfiledEngine
also delegates addsub, which the port's engines implement (a base
Engine would split it into copies, add and sub_reg and count those). The
calibration brackets its reps with eng.sync() (a CUDA synchronize on the
card), so its ms/op are device times plus the host's enqueue.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np

from ..engine.api import Engine, Reg

_ACTIVE: list["ProfiledEngine"] = []
_ENABLED = False


def set_profiling(on: bool) -> None:
    global _ENABLED
    _ENABLED = on
    if not on:
        _ACTIVE.clear()


def profiling_enabled() -> bool:
    return _ENABLED


def maybe_wrap(eng: Engine) -> Engine:
    if not _ENABLED:
        return eng
    pe = ProfiledEngine(eng)
    _ACTIVE.append(pe)
    return pe


class ProfiledEngine(Engine):
    """Counts every primitive op and its enqueue time; `report()` adds a
    sync-calibrated ms/op for the hot ops."""

    _OPS = ("square_mul", "square_mul_seq", "square_sub2_seq", "mul",
            "set_multiplicand", "add", "sub_reg", "addsub", "sub",
            "add_small", "copy", "set", "get_digits", "set_digits")

    def __init__(self, inner: Engine):
        super().__init__(inner.p, inner.reg_count)
        self.inner = inner
        self.counts: Counter = Counter()
        self.enqueue_s: Counter = Counter()

    def _timed(self, name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        self.counts[name] += 1
        self.enqueue_s[name] += time.perf_counter() - t0
        return r

    # -- delegation --------------------------------------------------------
    def get_size(self):
        return self.inner.get_size()

    @property
    def widths(self):
        return self.inner.widths

    def set(self, dst: Reg, a: int):
        self._timed("set", self.inner.set, dst, a)

    def copy(self, dst: Reg, src: Reg):
        self._timed("copy", self.inner.copy, dst, src)

    def square_mul(self, src: Reg, a: int = 1):
        self._timed("square_mul", self.inner.square_mul, src, a)

    def square_mul_seq(self, src: Reg, a_vec):
        self.counts["square_mul"] += max(len(a_vec) - 1, 0)
        self._timed("square_mul", self.inner.square_mul_seq, src, a_vec)

    def square_sub2_seq(self, src: Reg, count: int):
        self.counts["square_sub2"] += count
        t0 = time.perf_counter()
        self.inner.square_sub2_seq(src, count)
        self.enqueue_s["square_sub2"] += time.perf_counter() - t0

    def set_multiplicand(self, dst: Reg, src: Reg):
        self._timed("set_multiplicand", self.inner.set_multiplicand,
                    dst, src)

    def mul(self, dst: Reg, src: Reg, a: int = 1):
        self._timed("mul", self.inner.mul, dst, src, a)

    def sub(self, src: Reg, a: int):
        self._timed("sub", self.inner.sub, src, a)

    def add_small(self, src: Reg, a: int):
        self._timed("add_small", self.inner.add_small, src, a)

    def add(self, dst: Reg, src: Reg):
        self._timed("add", self.inner.add, dst, src)

    def sub_reg(self, dst: Reg, src: Reg):
        self._timed("sub_reg", self.inner.sub_reg, dst, src)

    def addsub(self, sum_out: Reg, diff_out: Reg, a: Reg, b: Reg):
        self._timed("addsub", self.inner.addsub, sum_out, diff_out, a, b)

    def sync(self):
        self.inner.sync()

    def get_digits(self, src: Reg) -> np.ndarray:
        return self._timed("get_digits", self.inner.get_digits, src)

    def set_digits(self, dst: Reg, digits: np.ndarray):
        self._timed("set_digits", self.inner.set_digits, dst, digits)

    def get_raw(self, src: Reg) -> np.ndarray:
        return self.inner.get_raw(src)

    def set_raw(self, dst: Reg, data: np.ndarray):
        self.inner.set_raw(dst, data)

    def get_raw_tagged(self, src: Reg):
        return self.inner.get_raw_tagged(src)

    def set_raw_tagged(self, dst: Reg, data: np.ndarray,
                       spectral: bool = False):
        self.inner.set_raw_tagged(dst, data, spectral)

    # -- reporting ---------------------------------------------------------
    def calibrate(self, reps: int = 4) -> dict[str, float]:
        """Sync-bracketed ms/op for the hot ops, measured on a scratch
        value in register 0 (caller must be done with real work)."""
        out = {}
        eng = self.inner
        eng.set(0, 3)

        def bench(name, fn):
            fn()          # warm (compile cached already, but first sync)
            eng.sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            eng.sync()
            out[name] = (time.perf_counter() - t0) / reps * 1e3

        bench("square_mul", lambda: eng.square_mul(0, 3))
        if self.counts.get("mul") or self.counts.get("set_multiplicand"):
            if self.reg_count >= 2:
                eng.set_multiplicand(1, 0)
                bench("set_multiplicand",
                      lambda: eng.set_multiplicand(1, 0))
                bench("mul", lambda: eng.mul(0, 1))
        if self.counts.get("add") or self.counts.get("sub_reg"):
            if self.reg_count >= 2:
                bench("add", lambda: eng.add(0, 0))
        return out

    def report(self, log=print, calibrate: bool = True) -> None:
        ms = self.calibrate() if calibrate else {}
        log(f"[profile] engine p={self.p} n={self.get_size()} "
            f"({type(self.inner).__name__})")
        log(f"[profile] {'op':18s} {'count':>10s} {'enq ms':>10s} "
            f"{'ms/op':>8s} {'est total s':>12s}")
        for name, cnt in self.counts.most_common():
            per = ms.get(name, float("nan"))
            est = per * cnt / 1e3 if per == per else float("nan")
            log(f"[profile] {name:18s} {cnt:>10d} "
                f"{self.enqueue_s[name]*1e3:>10.1f} {per:>8.3f} "
                f"{est:>12.2f}")


def report_all(log=print) -> None:
    for pe in _ACTIVE:
        try:
            pe.report(log)
        except Exception as e:  # profiling must never fail a finished run
            log(f"[profile] report failed: {e}")
    _ACTIVE.clear()
