"""The curve-batched engine: one register slab with a leading lane axis.

Counterpart of prmers_tpu/engine/batch.py (BatchJaxEngine). ECM runs K
curves whose stage-1 ladder and stage-2 schedule do not depend on the
curve, so the curves run as B lanes of one register file: every op
applies the same schedule to all lanes at once, and B curves cost about
one curve's launches (the any-size engine is launch-bound at the sizes
ECM runs). Host-side divergence (gcd hits, failed inversions, backtracks)
is resolved per lane by the mode drivers (modes/ecm.py,
modes/ecm_edwards.py).

BatchTorchEngine is a TorchEngine on one (reg_count, B, n) int64 slab of
u64 bit patterns: TorchEngine's ops (and its CUDA graphs, one per (op,
registers, multiplier), one pool per engine; graphs=False keeps every op
eager) apply to every lane at once, since ops/carry.carry_full
normalizes each vector along its last axis. What differs is the slab,
the transform and the host exchange. The transform is ops/ntt.py's on
ops/gl64.TorchField in lane form (forward_lanes, inverse_lanes: the lanes
ride along as one more lane axis of ntt.col_fwd / col_inv; every field op
is elementwise and exact, so each lane's words equal a single-lane
transform's bit for bit), and a multiplicand holds each lane's spectral
(C, R) words reshaped to n. Where the reference vmaps each op of
JaxEngine, this one passes the lane axis through. set, set_int and
get_int (per lane) copy between host and device and stay outside the
graphs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.plan import Plan
from ..ops import gl64 as gl
from ..ops import ntt
from ..utils import digits as dg
from .torch_engine import TorchEngine


def _mid_twiddle_lanes(F, x, t1, t2, R: int, C: int, tile: int):
    """ntt._mid_twiddle on (R, B, C): each lane's (R, C) matrix times the
    factored mid twiddles."""
    B = x.shape[1]
    v = x.reshape(R, B, C // tile, tile)
    v = F.mul(v, t1[:, None, :, None])
    v = F.mul(v, t2[:, None, None, :])
    return v.reshape(R, B, C)


def forward_lanes(F, t: ntt.NttTables, x):
    """ntt.forward on each lane of x (B, n): digits -> spectral (B, C, R)."""
    B = x.shape[0]
    x = F.mul(x, t.weights)
    x = x.reshape(B, t.R, t.C).swapaxes(0, 1)          # (R, B, C)
    x = ntt.col_fwd(F, x, t.stages_r)
    x = _mid_twiddle_lanes(F, x, t.mid_t1, t.mid_t2, t.R, t.C, t.mid_tile)
    x = ntt.col_fwd(F, x.swapaxes(0, 2), t.stages_c)   # (C, B, R)
    return x.swapaxes(0, 1)


def inverse_lanes(F, t: ntt.NttTables, z):
    """ntt.inverse on each lane of z (B, C, R): spectral -> unnormalized
    convolution digits (B, n)."""
    B = z.shape[0]
    x = ntt.col_inv(F, z.swapaxes(0, 1), t.stages_c)   # (C, B, R)
    x = x.swapaxes(0, 2)                                # (R, B, C)
    x = _mid_twiddle_lanes(F, x, t.mid_t1_inv, t.mid_t2_inv, t.R, t.C,
                           t.mid_tile)
    x = ntt.col_inv(F, x, t.stages_r)
    x = x.swapaxes(0, 1).reshape(B, t.n)
    return F.mul(x, t.inv_weights_n)


class BatchTorchEngine(TorchEngine):
    """Batched register file over the any-size engine's transform (see the
    module doc): TorchEngine's ops on a (reg_count, B, n) slab, its
    transform in lane form. The op surface is BatchJaxEngine's, with
    per-lane set_int and get_int."""

    def __init__(self, p: int, reg_count: int, batch: int,
                 plan: Plan | None = None, device=None, graphs=True):
        self.batch = batch
        super().__init__(p, reg_count, plan=plan, device=device,
                         graphs=None if graphs else False)
        self.n = self.plan.n

    def _alloc(self, n: int) -> None:
        self.regs = torch.zeros((self.reg_count, self.batch, n),
                                dtype=torch.int64, device=self.device)

    def _fwd(self, x: torch.Tensor):
        return forward_lanes(self.F, self.t, self.F.lift(x))

    def _inv(self, s):
        return inverse_lanes(self.F, self.t, s)

    # -- host exchange (never in a graph) ---------------------------------
    def set(self, dst: int, a: int) -> None:
        row = np.zeros(self.n, dtype=np.uint64)
        row[0] = a
        self.regs[dst].copy_(gl.from_numpy_u64(row, self.device))

    def set_int(self, dst: int, v: int, lane: int | None = None) -> None:
        row = gl.from_numpy_u64(dg.int_to_digits(v, self.plan.widths),
                                self.device)
        if lane is None:
            self.regs[dst].copy_(row)
        else:
            self.regs[dst, lane].copy_(row)

    def get_int(self, src: int, lane: int) -> int:
        return dg.digits_to_int(gl.to_numpy_u64(self.regs[src, lane]),
                                self.plan.widths)
