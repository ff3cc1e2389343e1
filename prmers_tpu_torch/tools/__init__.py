"""The port's twins of the reference's tools/ entry points that launch a
TPU kernel, each run on the card as `python -m prmers_tpu_torch.tools.<name>`
and printing one JSON line:

  profile_passes     tools/profile_passes.py: ms per pass at a full-width
                     plan, the folded passes of a step (K4, the
                     C-transform, K4 inverse) and the unfolded r passes
                     (K4u, K5u) in the matrix and the shift form
  microbench         tools/microbench3.py: serial int8 and bf16 matrix
                     products (torch._int_mm, torch.matmul: library calls,
                     as the TPU's were XLA dots) and the int32 mul+add and
                     gl64 mulmod rep loops (probe_vpu, probe_mulmod)
  microbench_fields  tools/microbench_fields.py: gl64, GF(M31^2) and
                     GF(M61^2) mul / sqr per element (probe_fields), and the
                     fft3161 break-even ratio
  probe_shapes       tools/exp_mosaic_shapes.py and exp_mosaic_shapes2.py:
                     cases a-n, each computed by a kernel (probe_shapes)
  probe_bitcast      tools/probe_bitcast.py: the byte order of u32 -> int8

and tools/validation_matrix.py's twin, `validation_matrix`, which runs no
kernel of its own: every mode on every backend and arithmetic, outcomes
compared (PRMERS_PLATFORM=cpu runs its CPU columns without a card).

The device-validation tools, twins of the reference's tools that drive the
production path end to end (each prints its rows, then one JSON line):

  gl_smoke         tools/gl_smoke.py: each bench exponent's PRP until its
                   first Gerbicz-Li check passes
  device_golden    tools/device_golden.py: the BASELINE.md goldens, the
                   error injection and a kill/resume mid-run
  ab_ladder        tools/ab_ladder.py: PRP iter/s for each pipeline switch,
                   one child each, and (--mesh) the one-rank mesh against
                   the single engine (tools/mesh_engine_device_check.py)
  settle_probe     tools/settle_probe.py: carry_full with the loop and with
                   static rounds, device ms and rounds
  lanecarry_check  tools/lanecarry_device_check.py and lanecarry_repro.py:
                   the T = 2 row carry against the hybrid at the 2^25 plan

Every tool needs a card and raises without one; the device-validation
tools run on the CPU where PRMERS_PLATFORM=cpu asks for it (`tool_device`),
as the tests run them. A kernel's time is taken
by CUDA events around each launch queued behind a device sleep (device
time, not the host's enqueue): the median of the pairs, with their mean
and largest beside it. The timed thunks allocate their outputs before the
first pair (the wrappers' `out=`), so no allocation falls between the
events; where a bound counts HBM bytes that a kernel reads once (the
shape probes), each pair starts from a cold L2 (`l2_flush`). Beside the
time stands its bound: the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the
card's peak for their type (for the rep-loop probes, the integer
instructions of their compiled loop, as slots of the busier integer pipe
(tools/sass.py), over the pipe's rate, `int_pipe_rate`: the loop's issue
rate, not what its function needs).
Each timed launch keeps its output, and `check` holds it against the
kernel's plain version on the same inputs (timing that too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, int8 tensor-core op/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
# a mod-P 64-bit product priced as the JAX's limb-plane form: 64 int8
# MACs, 128 int8 operations (the passes' products)
OPS_PER_PRODUCT = 128
# 32-bit integer lanes of an SM's integer pipe (CUDA's throughput table
# for compute capability 9.0: 64 results a clock an SM for integer add,
# logic, shift, compare and multiply-add). The SM has two such pipes, the
# ALU and the FMA pipe (IMAD); tools/sass.py counts a rep loop's slots on
# the busier one
INT_LANES_PER_SM = 64


def require_card():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("this tool measures the card: no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def on_cpu() -> bool:
    """The CPU asked for explicitly (the reference's PRMERS_PLATFORM=cpu,
    as tools/validation_matrix.py reads it)."""
    import os
    return os.environ.get("PRMERS_PLATFORM") == "cpu"


def tool_device():
    """The device a device-validation tool runs on: the CPU under
    PRMERS_PLATFORM=cpu, else the card (require_card raises without one)."""
    import torch
    return torch.device("cpu") if on_cpu() else require_card()


def device_name(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type == "cpu":
        return "cpu"
    from ..bench import card
    return card()


def sm_clock_hz() -> float:
    """The card's top SM clock (nvidia-smi's clocks.max.sm), in Hz."""
    import subprocess

    import torch
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits", "-i",
                        str(torch.cuda.current_device())],
                       capture_output=True, text=True, check=True)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def int_pipe_rate() -> float:
    """Slots a second of one integer pipe over the card: SMs x
    INT_LANES_PER_SM x the top SM clock (132 x 64 x 1.98 GHz = 1.67e13
    on an H100 SXM)."""
    import torch
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return sms * INT_LANES_PER_SM * sm_clock_hz()


def bound(ops: float, moved: float,
          rate: float = INT8_OPS_PER_S) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time for ops operations at
    rate and moved bytes at the HBM rate."""
    ops_ms = ops / rate * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


@dataclasses.dataclass(frozen=True)
class PairTimes:
    """The ms of each event pair of a device_ms run, and their median (the
    time a tool reports), mean and largest."""
    pairs: tuple

    @property
    def median(self) -> float:
        return float(np.median(self.pairs))

    @property
    def mean(self) -> float:
        return float(np.mean(self.pairs))

    @property
    def max(self) -> float:
        return float(np.max(self.pairs))

    def row(self) -> dict:
        return {"median_ms": self.median, "mean_ms": self.mean,
                "max_ms": self.max}


def l2_flush(dev) -> Callable[[], Any]:
    """A thunk that reads a scratch buffer of twice the card's L2 (its sum
    into a scalar made here), so that the next kernel finds none of its
    data in the L2 and reads it from HBM, as a bytes bound assumes. It
    leaves clean lines, so no write-back falls into the next kernel."""
    import torch
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 << 20)
    buf = torch.ones(2 * l2 // 4, dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    return lambda: torch.sum(buf, dim=0, out=total)


def device_ms(fn: Callable[[], Any], reps: int,
              flush: Callable[[], Any] | None = None
              ) -> tuple[PairTimes, Any]:
    """fn's device time over reps event pairs, and fn's last result: CUDA
    events around each call, each pair queued behind a device sleep (~1 ms)
    so the host has enqueued the call before the device reaches the first
    event, and behind flush (l2_flush) where one is given. A pair that the
    host stalls past the sleep (an allocation, a page fault) counts the
    idle card: the median ignores it, the mean and max show it."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return PairTimes(tuple(a.elapsed_time(b) for a, b in pairs)), out


def empty_launch_ms(reps: int = 32) -> PairTimes:
    """An empty kernel (a device sleep of 0 cycles) timed as device_ms
    times a kernel: the floor of the method, one launch that does
    nothing."""
    import torch
    return device_ms(lambda: torch.cuda._sleep(0), reps)[0]


def stream_ms(fn: Callable[[], Any], reps: int, warm: bool = True) -> float:
    """ms per call of fn over reps back-to-back calls (CUDA events around
    the run): for calls that queue many kernels (a plain version)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def max_abs_err(got, want) -> float:
    """The largest |got - want| over the elements that differ (u64 bit
    patterns for int64 tensors), 0.0 when equal."""
    import torch
    if got.shape != want.shape:
        return float("inf")
    if got.dtype == torch.int64:
        from ..ops import gl64 as gl
        a = gl.to_numpy_u64(got).reshape(-1)
        b = gl.to_numpy_u64(want).reshape(-1)
    else:
        a = got.detach().cpu().to(torch.int64).numpy().reshape(-1)
        b = want.detach().cpu().to(torch.int64).numpy().reshape(-1)
    bad = np.nonzero(a != b)[0]
    if bad.size == 0:
        return 0.0
    return float(max(abs(int(a[i]) - int(b[i])) for i in bad[:4096]))


@dataclasses.dataclass(eq=False)
class Timed:
    """One timed kernel call: its wrapper counter (`kernel`), a label, its
    pair times (`times`; `ms` their median) and bound, the output of its
    last timed launch (`got`), the plain version's call on the same inputs
    (`plain`), and the map both outputs go through before they compare
    (`norm`: canon for lazy values mod P; None, as they are). `check`
    fills plain_ms and max_abs_err."""
    kernel: str
    what: str
    times: PairTimes
    bound_ms: float
    bound_by: str
    got: Any
    plain: Callable[[], Any]
    norm: Callable[[Any], Any] | None = None
    plain_ms: float | None = None
    max_abs_err: float | None = None

    @property
    def ms(self) -> float:
        return self.times.median

    def row(self) -> dict:
        return {"kernel": self.kernel, "what": self.what, "ms": self.ms,
                "mean_ms": self.times.mean, "max_ms": self.times.max,
                "bound_ms": self.bound_ms, "bound_by": self.bound_by,
                "plain_ms": self.plain_ms, "max_abs_err": self.max_abs_err}


def check(entries: list[Timed], plain_reps: int = 1) -> list[Timed]:
    """Each entry's plain version on its inputs (timed over plain_reps
    calls), held against the kernel's output; raises on any difference."""
    for e in entries:
        want = e.plain()
        e.plain_ms = stream_ms(e.plain, plain_reps, warm=False)
        norm = e.norm or (lambda v: v)
        e.max_abs_err = max_abs_err(norm(e.got), norm(want))
        if e.max_abs_err != 0.0:
            raise AssertionError(f"{e.kernel} {e.what} disagrees with its "
                                 f"plain version (max_abs_err "
                                 f"{e.max_abs_err})")
    return entries


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (None skipped)."""
    return sum(a.numel() * a.element_size() for a in tensors
               if a is not None)
