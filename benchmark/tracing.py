"""The reading of a traced window: torch.profiler's events on the card
and the harness's "bench:" spans, on the profiler's one clock.

Device time is every device event that is not an annotation (kernels,
copies, sets), as prmers_tpu_torch/profile.py sums it; busy is the union
of their intervals inside the window span ("bench:window"), idle its
complement. Each idle gap is named by the innermost harness span open
over its middle (the label "driver", for the PRP driver's own code,
where only the window is), which says what the
host was doing while the device waited.
"""

from __future__ import annotations

from collections import defaultdict

WINDOW = "bench:window"
CHECK = "bench:gl_check"


def _union(intervals):
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _busy_in(merged, lo, hi) -> int:
    t = 0
    for s, e in merged:
        if e > lo and s < hi:
            t += min(e, hi) - max(s, lo)
    return t


def summarize(prof) -> dict:
    """Seconds: window, busy, device time by name, idle gaps by name;
    and each complete Gerbicz-Li check's span and its idle time."""
    from torch.autograd import DeviceType
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((s, e, ev.name()))
        elif ev.name().startswith("bench:"):
            spans.append((s, e, ev.name()))
    win = [sp for sp in spans if sp[2] == WINDOW]
    if not win or not device:
        return {}
    lo, hi = win[0][0], win[0][1]
    by_name = defaultdict(int)
    for s, e, name in device:
        if e > lo and s < hi:
            by_name[name] += min(e, hi) - max(s, lo)
    merged = _union((max(s, lo), min(e, hi)) for s, e, _ in device
                    if e > lo and s < hi)
    inner = sorted((sp for sp in spans if sp[2] != WINDOW),
                   key=lambda sp: sp[1] - sp[0])
    gaps = defaultdict(int)
    prev = lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            mid = (prev + s) // 2
            name = next((sp[2][len("bench:"):] for sp in inner
                         if sp[0] <= mid <= sp[1]), "driver")
            gaps[name] += s - prev
        prev = max(prev, e)
    checks = []
    for s, e, name in spans:
        if name == CHECK and any(sp[2] == "bench:get_int(R1)" and
                                 s <= sp[0] and sp[1] <= e for sp in spans):
            checks.append({"s": (e - s) / 1e9,
                           "idle_s": (e - s - _busy_in(merged, s, e)) / 1e9})
    ns = 1e-9
    return {"window_s": (hi - lo) * ns,
            "busy_s": _busy_in(merged, lo, hi) * ns,
            "device_s": {k: v * ns for k, v in by_name.items()},
            "idle_s": {k: v * ns for k, v in gaps.items()},
            "checks": checks}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by
    what the host was doing, each [name, seconds], at most `top`."""
    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": largest(summary["device_s"]),
            "idle_gaps": largest(summary["idle_s"])}
