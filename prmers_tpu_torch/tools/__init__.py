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

Every tool needs a card and raises without one. A kernel's time is taken
by CUDA events around each launch queued behind a device sleep (device
time, not the host's enqueue), beside its bound: the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
operations over the card's peak for their type. Each timed launch keeps
its output, and `check` holds it against the kernel's plain version on
the same inputs (timing that too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, int8 tensor-core op/s,
# float32 op/s outside the tensor cores (the nearest row to int32 work)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_OPS_PER_S = 67e12
# a mod-P (or M61) 64-bit product priced as the JAX's limb-plane form: 64
# int8 MACs, 128 int8 operations; an M31 one as 16 MACs
OPS_PER_PRODUCT = 128
OPS_PER_M31_PRODUCT = 32


def require_card():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("this tool measures the card: no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def bound(ops: float, moved: float,
          rate: float = INT8_OPS_PER_S) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time for ops operations at
    rate and moved bytes at the HBM rate."""
    ops_ms = ops / rate * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def device_ms(fn: Callable[[], Any], reps: int) -> tuple[float, Any]:
    """ms per call of fn on the device, and fn's last result: CUDA events
    around each call, each pair queued behind a device sleep (~1 ms) so the
    host has enqueued the call before the device reaches the first
    event."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps, out


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
    ms and bound, the output of its last timed launch (`got`), the plain
    version's call on the same inputs (`plain`), and the map both outputs
    go through before they compare (`norm`: canon for lazy values mod P;
    None, as they are). `check` fills plain_ms and max_abs_err."""
    kernel: str
    what: str
    ms: float
    bound_ms: float
    bound_by: str
    got: Any
    plain: Callable[[], Any]
    norm: Callable[[Any], Any] | None = None
    plain_ms: float | None = None
    max_abs_err: float | None = None

    def row(self) -> dict:
        return {"kernel": self.kernel, "what": self.what, "ms": self.ms,
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
