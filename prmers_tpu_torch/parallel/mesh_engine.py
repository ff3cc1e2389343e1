"""MeshEngine: the Engine register API over the mesh.

Counterpart of prmers_tpu/parallel/mesh_engine.py:MeshPallasEngine. A
register is [x, co, spectral] on each rank: x the rank's r1-sharded digits
(R1/s, R2, C), co its unit carries (R1/s, R2, T), not yet rolled (None for
a multiplicand), and the spectral flag. The hot ops (square_mul,
square_mul_seq, square_sub2_seq, set_multiplicand, mul) run the row-carry
mesh step of parallel/sharded_kernels; a sequence is one step per
squaring (the JAX scans chunks of _SEQ_CHUNK = 256 in one dispatch; the
port launches each step's kernels in turn, so there is nothing to chunk).
The linear ops (add, sub, sub_reg, add_small) settle the deferred carries
and renormalize with a carry ring across the ranks (ring_carry), once per
Gerbicz block, never in the iteration loop. Host exchange gathers through
parallel/dist, so every rank gets the whole value.

The LL step fuses its -2 into K3 (the amount on rank 0 only). The JAX's
PRMERS_MESH_SEQ_STEPWISE (square, then sub: mesh_engine.py:354-356) only
reuses compiled single-step programs, and the port compiles none, so it is
not read here. The engine needs the row carry, as the JAX's
(mesh_engine.py:228-230): the block-carry mesh path is ShardedStep.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.plan import build_plan, cached_plan
from ..engine.api import Engine, Reg
from ..engine.fourstep_engine import four_step_plan
from ..ops import carry as carry_ops
from ..ops import fourstep as tfs
from ..ops import gl64 as gl
from ..utils import digits as dg
from . import dist
from .sharded_kernels import (check_mesh, ring_roll, row_step,
                              sharded_tables)


def mesh_eligible(p: int, s: int | None = None, n: int | None = None) -> bool:
    """Would MeshEngine take (p, s ranks)? (mesh_engine.py:48-69; s
    defaults to the group's world size.)"""
    s = dist.process_count() if s is None else s
    try:
        plan = build_plan(p, n=n) if n else cached_plan(p)
        check_mesh(four_step_plan(plan, tfs.Pipeline(r2fold_max=0)), s)
    except (NotImplementedError, ValueError):
        return False
    return True


def ring_carry(y: torch.Tensor, wid: torch.Tensor, msk: torch.Tensor,
               absorb: int = 1) -> torch.Tensor:
    """Carry propagation of the rank's flat digits y across the ring (the
    last rank's carry wraps to rank 0: the mod-M_p fold), O(absorb +
    log n) (mesh_engine.py:76-124): `absorb` shift-and-add rounds bring
    every carry to 0 or 1, then one more shift and a generate/propagate
    prefix within the rank (ops/carry._prefix_scan), and a cyclic (G, P)
    fixpoint over the ranks' aggregates. The all-propagate cycle resolves
    to no carry, keeping the all-ones form of 0 == M_p."""
    d = y & msk
    c = y >> wid
    for _ in range(absorb):
        t = d + ring_roll(c)
        c = t >> wid
        d = t & msk
    t = d + ring_roll(c)
    g = (t >> wid) != 0
    p = (t & msk) == msk
    G, Pf = carry_ops._prefix_scan(g, p)
    agg = dist.all_gather_scalars(torch.stack([G[-1], Pf[-1]]).long())
    gs, ps = agg[:, 0] != 0, agg[:, 1] != 0
    k = torch.roll(gs, 1)
    for _ in range(agg.shape[0] - 1):
        k = torch.roll(gs, 1) | (torch.roll(ps, 1) & torch.roll(k, 1))
    k0 = k[dist.rank()]
    kin = torch.cat([k0[None], G[:-1] | (Pf[:-1] & k0)])
    return (t + kin.long()) & msk


class MeshEngine(Engine):
    """Engine over the row-carry mesh step (see the module docstring)."""

    backend_name = "sharded"

    def __init__(self, p: int, reg_count: int, device=None,
                 n: int | None = None, pipe: tfs.Pipeline = tfs.Pipeline()):
        super().__init__(p, reg_count)
        if not pipe.rowcarry:
            raise ValueError("MeshEngine needs the row carry "
                             "(PRMERS_NO_ROWCARRY is set); the block-carry "
                             "mesh path is ShardedStep")
        self.plan = build_plan(p, n=n) if n else cached_plan(p)
        self.tables = tb = sharded_tables(self.plan, pipe, device)
        self.device = tb.device
        self.n = self.plan.n
        self.mp = (1 << p) - 1
        # the rank's digits are a contiguous run of the digit order
        self._wid = tb.t1.widths.reshape(-1).long()
        self._msk = (1 << self._wid) - 1
        # injected unit carries are < 2^64 and each absorb round divides a
        # carry by 2^wmin (mesh_engine.py:143-146)
        self._absorb = -(-64 // int(self.plan.widths.min())) + 1
        self.regs = [[self._zx(), self._zc(), False]
                     for _ in range(reg_count)]
        self._delta_cache: dict[int, torch.Tensor] = {}

    # -- helpers ----------------------------------------------------------
    def _zx(self):
        return torch.zeros(self.tables.shape, dtype=torch.int64,
                           device=self.device)

    def _zc(self):
        return torch.zeros(self.tables.carry_shape, dtype=torch.int64,
                           device=self.device)

    def _local(self, data: np.ndarray) -> torch.Tensor:
        d = np.asarray(data, dtype=np.uint64).reshape(self.tables.fp.shape)
        return gl.from_numpy_u64(dist.put_global(d), self.device)

    def _digits(self, r: Reg):
        st = self.regs[r]
        assert not st[2], "spectral register used as digits"
        return st[0], st[1]

    def _settled(self, r: Reg) -> torch.Tensor:
        """The register's digits with its pending carries folded in (each
        unit's carry enters the next unit's first digit) and renormalized
        (mesh_engine.py:137-171)."""
        x, co = self._digits(r)
        units = co.numel()
        y = x.reshape(units, -1).clone()
        y[:, 0] += ring_roll(co).reshape(-1)
        d = ring_carry(y.reshape(-1), self._wid, self._msk, self._absorb)
        x = d.reshape(x.shape)
        self.regs[r] = [x, self._zc(), False]
        return x

    def _linear(self, x, y, coef_y: int, const=None) -> torch.Tensor:
        """digits(x) + coef_y * digits(y) (coef -1: masks - y) + const on
        settled registers; a sum below 3 * mask needs one absorb round
        (mesh_engine.py:174-195)."""
        a = x.reshape(-1)
        b = y.reshape(-1)
        if coef_y < 0:
            b = self._msk - b
        elif coef_y == 0:
            b = torch.zeros_like(b)
        s = a + b if const is None else a + b + const
        return ring_carry(s, self._wid, self._msk).reshape(x.shape)

    def get_size(self) -> int:
        return self.n

    @property
    def widths(self) -> np.ndarray:
        return self.plan.widths

    # -- core ops ---------------------------------------------------------
    def set(self, dst: Reg, a: int) -> None:
        self.set_int(dst, a)

    def copy(self, dst: Reg, src: Reg) -> None:
        if dst == src:
            return
        st = self.regs[src]
        self.regs[dst] = [st[0].clone(),
                          None if st[1] is None else st[1].clone(), st[2]]

    def square_mul(self, src: Reg, a: int = 1) -> None:
        x, co = self._digits(src)
        self.regs[src] = [*row_step(self.tables, x, co, a=int(a)), False]

    def square_mul_seq(self, src: Reg, a_vec) -> None:
        for a in a_vec:
            self.square_mul(src, int(a))

    def square_sub2_seq(self, src: Reg, count: int) -> None:
        for _ in range(count):
            x, co = self._digits(src)
            self.regs[src] = [*row_step(self.tables, x, co, sub2=True),
                              False]

    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        x, co = self._digits(src)
        self.regs[dst] = [row_step(self.tables, x, co, "fwd"), None, True]

    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        u = self.regs[src]
        assert u[2], "mul src must hold a multiplicand"
        x, co = self._digits(dst)
        self.regs[dst] = [*row_step(self.tables, x, co, "mul", u=u[0],
                                    a=int(a)), False]

    # -- linear ops (settled digits, the carry ring) ----------------------
    def add(self, dst: Reg, src: Reg) -> None:
        x = self._settled(dst)
        y = self._settled(src)
        self.regs[dst] = [self._linear(x, y, 1), self._zc(), False]

    def sub_reg(self, dst: Reg, src: Reg) -> None:
        x = self._settled(dst)
        y = self._settled(src)
        self.regs[dst] = [self._linear(x, y, -1), self._zc(), False]

    def _delta_vec(self, a: int) -> torch.Tensor:
        if a not in self._delta_cache:
            d = dg.int_to_digits(a % self.mp, self.widths)
            self._delta_cache[a] = self._local(d).reshape(-1)
        return self._delta_cache[a]

    def sub(self, src: Reg, a: int) -> None:
        self.add_small(src, self.mp - (a % self.mp))

    def add_small(self, src: Reg, a: int) -> None:
        x = self._settled(src)
        self.regs[src] = [self._linear(x, x, 0, self._delta_vec(a)),
                          self._zc(), False]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host exchange ----------------------------------------------------
    def get_digits(self, src: Reg) -> np.ndarray:
        x = dist.global_gather(self._settled(src))
        return gl.to_numpy_u64(x).reshape(self.n)

    def set_digits(self, dst: Reg, digits: np.ndarray) -> None:
        self.regs[dst] = [self._local(digits), self._zc(), False]

    def get_raw(self, src: Reg) -> np.ndarray:
        """Checkpoint dump: settled digits, or a multiplicand's spectral
        values, canonical mod P in the flat (R1, R2, C) order, as
        FourStepEngine dumps them."""
        st = self.regs[src]
        if st[2]:
            u = dist.global_gather(gl.canon64(st[0]))
            return gl.to_numpy_u64(u).reshape(self.n)
        return self.get_digits(src)

    def get_raw_tagged(self, src: Reg) -> tuple[np.ndarray, bool]:
        return self.get_raw(src), bool(self.regs[src][2])

    def set_raw(self, dst: Reg, data: np.ndarray) -> None:
        self.set_digits(dst, data)

    def set_raw_tagged(self, dst: Reg, data: np.ndarray,
                       spectral: bool = False) -> None:
        if not spectral:
            self.set_digits(dst, data)
            return
        self.regs[dst] = [self._local(data), None, True]
