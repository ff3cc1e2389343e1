"""The kernels of one squaring over the mesh, per rank.

Counterpart of prmers_tpu/parallel/sharded_pallas.py. At rest a register
is r1-sharded: rank r of s holds x (R1/s, R2, C) and its out-carries, not
yet rolled: (R1/s, R2, T) per carry unit on the row carry, (R1/s, 1) per
r1 block on the block carry. A step runs the port's kernels on the rank's
shard views of the tables (ops/kernels.R2_VIEW, R1_VIEW) with the
collectives of parallel/dist between them, as the JAX's shard_map bodies
do:

  row carry (the default; sharded_pallas.py:428-510)
    ring     the unit carries rolled by one unit (ring_prev brings the
             previous rank's last one; the last rank's wraps to rank 0,
             the mod-M_p fold)
    to_r2    x, and the rolled carries with it, so the rows stay aligned
    K1       inject, wrap halve, r1 DFT                       (R2_VIEW)
    to_r1
    K5 P2, K6 (K6 "fwd" + K6b at C = 8192), K5 P6             (R1_VIEW)
    to_r2
    K3       r1 inverse, canon, x a or the LL sub2, unit carries (R2_VIEW;
             the amount 2 on rank 0 only, which holds global digit 0)
    to_r1    digits and carries
  block carry (Pipeline(rowcarry=False); sharded_pallas.py:261-312)
    inject   the block carries rolled by one block over the ring, spread
             over the first digits of each local r1 block (torch code, as
             the JAX's XLA strip `_inject_local`)
    to_r2, K4 forward without carries, to_r1, K5 P2, K6 [+ K6b], K5 P6,
    to_r2, K4 inverse, to_r1, K8 (K7's kernel, K8's round rule; R1_VIEW)

The mesh never folds the r2 passes into K2 (its plan has r2fold_max = 0,
so kernels.fused_mid takes the K5 branch) and never runs K9. K1 rolls its
carries by one unit itself (csrc/k1_p1c.cu), so after the ring roll and
the move the carries are rolled back by one unit within the rank; at
s = 1 the two rolls cancel and K1 takes the carries as they are. No step
changes its inputs.

ShardedTables holds a rank's views, built once per process per plan,
carry unit, world size, rank and device, and shared by ShardedStep (the
wrapper with digits in and out, sharded_pallas.py:513-641) and MeshEngine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.plan import Plan, build_plan, cached_plan
from ..engine.fourstep_engine import four_step_plan, host_tables
from ..ops import fourstep as tfs
from ..ops import gl64 as gl
from ..ops import kernels as tk
from ..utils import digits as dg
from . import dist

_VIEWS: dict = {}


def check_mesh(fp: tfs.FourStepPlan, s: int) -> None:
    """The shapes the mesh step takes (mesh_engine.py:48-69,
    sharded_pallas.py:62-76): the lane-tiled carry (not the hybrid), s
    dividing R1 and R2, and the fused C-transform's tables (R1 >= 32, ca =
    C / 128 a power of two from 2 to 64); ValueError with the shape
    otherwise. A radix-5 plan (n = 5 * 2^k, R2 = 5 * 2^b) is taken on the
    same terms: s divides R2 when it divides 2^b (or is 5 times such)."""
    R1, R2, C = fp.shape
    ca = C // tfs.LANES
    if tfs.use_xla_carry(fp) or R1 % s or R2 % s or C % tfs.LANES or \
            R1 < 32 or not 2 <= ca <= 64 or ca & (ca - 1):
        raise ValueError(
            f"no mesh step for {s} ranks at n={fp.n}: (R1, R2, C) = "
            f"{fp.shape}; the world size must divide R1 and R2, and the "
            f"pipeline must be the row or the block carry ({fp.pipe})")


@dataclasses.dataclass(eq=False)
class ShardedTables:
    """A rank's shard views of the kernel tables (sharded_pallas.py:52-158):
    t2 r2-sharded (K1, K3, K4), t1 r1-sharded (K5, K6, K6b, K8)."""
    fp: tfs.FourStepPlan
    s: int
    rank: int
    t2: tk.DevTables
    t1: tk.DevTables

    @property
    def shape(self) -> tuple[int, int, int]:
        """The rank's register at rest: (R1/s, R2, C)."""
        return self.t1.shape

    @property
    def carry_shape(self) -> tuple:
        """The rank's carries at rest: (R1/s, R2, T), or (R1/s, 1) on the
        block carry."""
        R1s, R2, C = self.shape
        if self.rowcarry:
            return (R1s, R2, C // self.t1.ct)
        return (R1s, 1)

    @property
    def rowcarry(self) -> bool:
        return tfs.use_rowcarry(self.fp)

    @property
    def device(self) -> torch.device:
        return self.t1.device


def sharded_tables(plan: Plan, pipe: tfs.Pipeline = tfs.Pipeline(),
                   device=None) -> ShardedTables:
    """This rank's tables for the group's world size (dist); the host
    tables are the single-card engine's (fourstep_engine.host_tables)."""
    s, rank = dist.process_count(), dist.rank()
    fp = four_step_plan(plan, dataclasses.replace(pipe, r2fold_max=0))
    check_mesh(fp, s)
    dev = dist.device(device)
    key = (plan.p, plan.n, tfs.carry_ct(fp), s, rank, str(dev))
    if key not in _VIEWS:
        kt = host_tables(fp)
        _VIEWS[key] = tuple(tk.DevTables.from_host(kt, dev, view, rank, s)
                            for view in (tk.R2_VIEW, tk.R1_VIEW))
    t2, t1 = _VIEWS[key]
    return ShardedTables(fp=fp, s=s, rank=rank,
                         t2=dataclasses.replace(t2, fp=fp),
                         t1=dataclasses.replace(t1, fp=fp))


def ring_roll(c: torch.Tensor) -> torch.Tensor:
    """The rank's carries rolled by one in flat order across the ring."""
    flat = c.reshape(-1)
    return torch.cat([dist.ring_prev(flat[-1:]),
                      flat[:-1]]).reshape(c.shape)


def k1_carries(tb: ShardedTables, co: torch.Tensor) -> torch.Tensor:
    """The r1-sharded unit carries co as K1 takes them under r2 sharding:
    rolled by one unit over the ring, moved with the digits, and rolled
    back by one unit within the rank for K1's own roll."""
    if tb.s == 1:
        return co
    c2 = dist.to_r2_sharded(ring_roll(co))
    return torch.roll(c2.reshape(-1), -1).reshape(c2.shape)


def inject_local(tb: ShardedTables, x: torch.Tensor,
                 co: torch.Tensor) -> torch.Tensor:
    """x with the block carries co, rolled by one block over the ring,
    spread over the first bk digits of each local r1 block
    (sharded_pallas.py:162-179)."""
    t = tb.t1
    parts = tk.inject_parts(ring_roll(co).reshape(-1), t.bwt, t.bcum)
    y = x.clone()
    y[:, 0, :t.bk] += parts          # digits < 2^32: no u64 wrap
    return y


def row_step(tb: ShardedTables, x: torch.Tensor, co: torch.Tensor,
             mode: str = "sqr", u: torch.Tensor | None = None, a: int = 1,
             sub2: bool = False):
    """One row-carry step of the rank (x^2 * a, x * u * a, or x^2 - 2 with
    sub2); returns (x, co), or for mode "fwd" the spectral multiplicand in
    the r1 layout (what "mul" takes as u)."""
    x2 = dist.to_r2_sharded(x)
    y = tk.p1_carry_pass(tb.t2, x2, k1_carries(tb, co),
                         out=None if x2 is x else x2)
    y = tk.fused_mid(tb.t1, dist.to_r1_sharded(y), mode, u=u)
    if mode == "fwd":
        return y
    z = dist.to_r2_sharded(y)
    d, c = tk.p7_carry_pass(tb.t2, z, a=a, sub2=sub2, out=z,
                            s2=2 if tb.rank == 0 else 0)
    return dist.to_r1_sharded(d), dist.to_r1_sharded(c)


def block_step(tb: ShardedTables, x: torch.Tensor, co: torch.Tensor,
               a: int = 1):
    """One block-carry step of the rank, x^2 * a; returns (x, co)."""
    y = dist.to_r2_sharded(inject_local(tb, x, co))
    y = tk.axis0_pass(tb.t2, y, False, out=y)
    y = tk.fused_mid(tb.t1, dist.to_r1_sharded(y), "sqr")
    z = dist.to_r2_sharded(y)
    z = tk.axis0_pass(tb.t2, z, True, out=z)
    return tk.block_carry_local(tb.t1, dist.to_r1_sharded(z), a)


class ShardedStep:
    """The step over the group, digits in and out (sharded_pallas.py:
    513-641): the row carry by default, the block carry (K8) with
    pipe=Pipeline(rowcarry=False). Every rank calls every method with the
    same arguments; x and co are the rank's state."""

    def __init__(self, p: int, n: int | None = None,
                 pipe: tfs.Pipeline = tfs.Pipeline(), device=None):
        self.plan = build_plan(p, n=n) if n else cached_plan(p)
        self.tables = sharded_tables(self.plan, pipe, device)
        self.fp = self.tables.fp
        self.x = self._zeros(self.tables.shape)
        self.co = self._zeros(self.tables.carry_shape)
        self.u = None

    def _zeros(self, shape):
        return torch.zeros(shape, dtype=torch.int64,
                           device=self.tables.device)

    def _local(self, digits: np.ndarray) -> torch.Tensor:
        d = np.asarray(digits, dtype=np.uint64).reshape(self.fp.shape)
        return gl.from_numpy_u64(dist.put_global(d), self.tables.device)

    def set_digits(self, digits: np.ndarray) -> None:
        self.x = self._local(digits)
        self.co = self._zeros(self.tables.carry_shape)

    def get_int(self) -> int:
        """The value, the pending carries included: carry b enters the
        first digit of unit or block b + 1, the last one digit 0."""
        x = gl.to_numpy_u64(dist.global_gather(self.x)).reshape(-1)
        co = gl.to_numpy_u64(dist.global_gather(self.co)).reshape(-1)
        w = self.plan.widths
        offs = dg.bit_positions(w)
        bs = x.size // co.size
        v = dg.digits_to_int(x, w)
        for b, c in enumerate(np.roll(co, 1).tolist()):
            v += int(c) << int(offs[b * bs])
        return v % ((1 << self.plan.p) - 1)

    def step(self, count: int = 1, a: int = 1) -> None:
        """count iterations of x <- x^2 * a."""
        tb = self.tables
        for _ in range(count):
            if tb.rowcarry:
                self.x, self.co = row_step(tb, self.x, self.co, a=a)
            else:
                self.x, self.co = block_step(tb, self.x, self.co, a)

    def prepare_multiplicand(self, digits: np.ndarray) -> None:
        """The spectral multiplicand of a digit vector (row carry only, as
        sharded_pallas.py:611)."""
        if not self.tables.rowcarry:
            raise ValueError("mesh multiplicands need the row carry")
        self.u = row_step(self.tables, self._local(digits),
                          self._zeros(self.tables.carry_shape), "fwd")

    def mul(self, a: int = 1) -> None:
        """x <- x * multiplicand * a."""
        if self.u is None:
            raise ValueError("prepare_multiplicand first")
        self.x, self.co = row_step(self.tables, self.x, self.co, "mul",
                                   u=self.u, a=a)
