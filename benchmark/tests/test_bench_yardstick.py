"""The roofline count against PERF.md section 3's products a digit, and
the tracing arithmetic on a synthetic timeline."""

import math

import pytest

from benchmark import tracing, yardstick


def test_products_per_digit_match_perf_md():
    assert yardstick.products_per_digit(64, 64, 2048) == 32      # 2^23
    assert yardstick.products_per_digit(64, 320, 1024) == pytest.approx(
        32.975)                                                  # 5 * 2^22
    assert round(yardstick.products_per_digit(64, 128, 8192)) == 35  # 2^26


def test_least_time_on_an_h100():
    plan = {"n": 1 << 23, "R1": 64, "R2": 64, "C": 2048, "T": 1}
    ms, what = yardstick.least_ms_per_squaring(plan, 132, 1.98e9)
    assert what == "operations"
    assert ms == pytest.approx(32 * 2**23 * 8 / (132 * 64 * 1.98e9) * 1e3)
    assert ms == pytest.approx(0.1284, abs=1e-4)
    bytes_ms = 16 * (2**23 + 4096) / 3.35e12 * 1e3
    assert bytes_ms == pytest.approx(0.0401, abs=1e-4) and bytes_ms < ms
    plan5 = {"n": 5 << 22, "R1": 64, "R2": 320, "C": 1024, "T": 1}
    ms5, _ = yardstick.least_ms_per_squaring(plan5, 132, 1.98e9)
    assert ms5 == pytest.approx(0.3307, abs=1e-4)


def test_idle_share():
    assert yardstick.idle_share(0.755, 0.944) == pytest.approx(0.2002,
                                                               abs=1e-4)


class _Ev:
    def __init__(self, name, s, e, cuda, annotation=False):
        from torch.autograd import DeviceType
        self._n, self._s, self._e = name, s, e
        self._d = DeviceType.CUDA if cuda else DeviceType.CPU
        self._a = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {})()
        self.profiler.kineto_results.events = lambda: events


def test_summarize_a_timeline():
    s = 1_000_000_000
    events = [
        _Ev("bench:window", 0, 10 * s, False, True),
        _Ev("bench:square_mul_seq(R0)", 0, int(3.6 * s), False, True),
        _Ev("bench:gl_check", 4 * s, 9 * s, False, True),
        _Ev("bench:square_mul_seq(R3)", 4 * s, 6 * s, False, True),
        _Ev("bench:get_int(R3)", 6 * s, 7 * s, False, True),
        _Ev("bench:get_int(R1)", 7 * s, 9 * s, False, True),
        _Ev("k2", 0, 3 * s, True),
        _Ev("k1", int(3.5 * s), int(3.7 * s), True),
        _Ev("k2", 4 * s, 6 * s, True),
        _Ev("k4", 7 * s, int(7.2 * s), True),
        _Ev("gpu annotation", 0, 10 * s, True, True),    # not device time
        _Ev("k3", int(9.5 * s), 11 * s, True),           # cut at the end
    ]
    sm = tracing.summarize(_Prof(events))
    assert sm["window_s"] == 10 and sm["busy_s"] == pytest.approx(5.9)
    assert sm["device_s"] == pytest.approx(
        {"k2": 5.0, "k1": 0.2, "k4": 0.2, "k3": 0.5})
    assert sm["idle_s"] == pytest.approx(
        {"square_mul_seq(R0)": 0.5, "driver": 0.3, "get_int(R3)": 1.0,
         "get_int(R1)": 2.3})
    assert len(sm["checks"]) == 1
    assert sm["checks"][0]["idle_s"] == pytest.approx(2.8)
    bd = tracing.breakdown(sm, top=2)
    assert bd["device_ops"] == [["k2", 5.0], ["k3", 0.5]]
    assert bd["idle_gaps"][0] == ["get_int(R1)", pytest.approx(2.3)]
    assert not math.isnan(sm["busy_s"])
