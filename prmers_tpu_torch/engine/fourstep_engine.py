"""The four-step kernel engine: the Engine register API on the port's
kernels (ops/kernels.py).

Counterpart of prmers_tpu/engine/pallas_engine.py:PallasEngine. A
register is [x, co, spectral]: x the (R1, R2, C) int64 digit tensor (u64
bit patterns), co the int64 out-carries of the last step, not yet rolled
(they enter the next step's K1 or K4, or are folded by `op_settle`), and
the spectral flag of a multiplicand. On the row-carry pipeline (the
default) co is (R1, R2, T), one per carry unit (T per row); on the
block-carry pipeline and the hybrid (ops/fourstep.Pipeline rowcarry=False
or xla_carry=True) it is (R1, 1), one per r1 block, and the hybrid's stay
zero. The LL step fuses its -2 only on the row carry; elsewhere
square_sub2_seq is Engine's square, then sub, as pallas_engine.py:329-331.

Where the JAX package takes its whole-chain kernel (fourstep.chain_ok: n =
2^15 ... 2^19 with the default pipeline), square_mul and square_mul_seq
run K9, one launch per chunk of up to CHAIN_K squarings, as
pallas_engine.py:273-308 does; square_sub2_seq, set_multiplicand and mul
stay on the three-kernel step there too (:328-341).

The hot ops update their register's tensors in place (the kernels read
each element before writing it), so `copy` always makes real copies and no
two registers ever share storage. Settle and the linear ops (get/set,
add/sub) are torch code on the device around ops/carry.carry_full.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import torchconf
from ..core.plan import Plan, cached_plan
from ..utils import digits as dg
from .api import Engine, Reg
from ..ops import carry as carry_ops
from ..ops import fourstep as tfs
from ..ops import gl64 as gl
from ..ops import kernels as tk

_HOST_TABLES: dict = {}
_DEV_TABLES: dict = {}


# The radix-5 transforms: n = 5 * 2^k from 163840 (the JAX's floor,
# factory.py:51-53) up to this cap, 5 * 2^25 (MM31), the largest plan the
# JAX four-step path takes.
R5_MIN, R5_MAX = 5 << 15, 5 << 25


def check_shape(fp: tfs.FourStepPlan) -> None:
    """The shapes this engine covers, with every branch of the JAX
    row-carry pipeline the plan selects (r2 passes folded or as K5, the
    C-transform whole or split, carry units of 256 to 4096 digits): n = 2^k
    with 2^15 <= n <= 2^26, and n = 5 * 2^k with 163840 <= n <= 5 * 2^25
    (L2 = 5 * 2^b <= 320) under the plan conditions of the JAX
    _pallas_eligible (factory.py:45-59: L1 >= 32, C % 128 = 0, 2 <= ca <=
    64, ca a power of two). Anything else raises: the port never falls
    back to another pipeline."""
    n = fp.n
    L2, ca = fp.rs.L2, fp.C // tfs.LANES
    if n % 5:
        sized = n & (n - 1) == 0 and (1 << 15) <= n <= (1 << 26) \
            and L2 & (L2 - 1) == 0
    else:
        b = n // 5
        sized = b & (b - 1) == 0 and R5_MIN <= n <= R5_MAX and L2 <= 320
    ok = (sized and fp.rs.L1 >= 32 and fp.C % tfs.LANES == 0
          and 2 <= ca <= 64 and ca & (ca - 1) == 0
          and 256 <= tfs.carry_ct(fp) <= 4096)
    if not ok:
        raise NotImplementedError(
            f"prmers_tpu_torch covers n = 2^k with 2^15 <= n <= 2^26 and "
            f"n = 5*2^k with {R5_MIN} <= n <= {R5_MAX}; this plan has "
            f"n={n} (R1={fp.rs.L1}, R2={L2}, C={fp.C}, "
            f"carry_ct={tfs.carry_ct(fp)})")


def four_step_plan(plan: Plan, pipe: tfs.Pipeline) -> tfs.FourStepPlan:
    """The kernel plan of a plan under a pipeline, for the shapes
    check_shape covers; NotImplementedError for any other."""
    try:
        fp = tfs.FourStepPlan.from_plan(plan, pipe)
    except AssertionError as e:
        raise NotImplementedError(
            f"prmers_tpu_torch has no four-step plan for n={plan.n}: "
            f"{e}") from None
    check_shape(fp)
    return fp


def host_tables(fp: tfs.FourStepPlan) -> tfs.KernelTables:
    """The host tables of a kernel plan. They depend on the pipeline only
    through the carry unit, so pipelines with one unit share one build,
    and so do the mesh's shard views of it."""
    key = (fp.p, fp.n, tfs.carry_ct(fp))
    if key not in _HOST_TABLES:
        _HOST_TABLES[key] = tfs.build_tables(fp)
    return _HOST_TABLES[key]


def get_tables(plan: Plan, device: torch.device,
               pipe: tfs.Pipeline = tfs.Pipeline()):
    """The kernel tables of a plan under a pipeline on a device: one
    device copy for pipelines with one carry unit."""
    fp = four_step_plan(plan, pipe)
    key = (plan.p, plan.n, tfs.carry_ct(fp), str(device))
    if key not in _DEV_TABLES:
        _DEV_TABLES[key] = tk.DevTables.from_host(host_tables(fp), device)
    return dataclasses.replace(_DEV_TABLES[key], fp=fp)


def op_settle(t: tk.DevTables, x: torch.Tensor,
              co: torch.Tensor) -> torch.Tensor:
    """Fold the pending carries (the carry of unit or r1 block u enters
    its first digit of u+1, the last one's wraps to digit 0) and
    renormalize (pallas_engine.py:161-183)."""
    n = x.numel()
    y = x.reshape(n).clone()
    y[::n // co.numel()] += torch.roll(co.reshape(-1), 1)
    return carry_ops.carry_full(y, t.widths.reshape(n)).reshape(t.shape)


def op_linear(t: tk.DevTables, x: torch.Tensor, y: torch.Tensor,
              coef_y: int, const: torch.Tensor | None = None):
    """digits(x) + coef_y * digits(y) (coef -1: add masks - y) + const,
    renormalized (pallas_engine.py:186-202); x and y are settled."""
    n = x.numel()
    w = t.widths.reshape(n).to(torch.int64)
    masks = (1 << w) - 1
    a = x.reshape(n)
    b = y.reshape(n)
    if coef_y < 0:
        b = masks - b
    elif coef_y == 0:
        b = torch.zeros_like(b)
    s = a + b
    if const is not None:
        s = s + const
    return carry_ops.carry_full(s, w, masks).reshape(t.shape)


class FourStepEngine(Engine):
    """Engine backed by the port's kernels (CUDA on a card, plain torch on
    the CPU). `pipe` overrides the budgets that pick the pipeline's
    branches (ops/fourstep.Pipeline; the default is the JAX package's)."""

    def __init__(self, p: int, reg_count: int, plan: Plan | None = None,
                 device=None, pipe: tfs.Pipeline = tfs.Pipeline()):
        super().__init__(p, reg_count)
        self.device = torchconf.device(device)
        self.plan = plan if plan is not None else cached_plan(p)
        self.n = self.plan.n
        self.t = get_tables(self.plan, self.device, pipe)
        self._sh = self.t.shape
        self.regs = [[self._zx(), self._zc(), False]
                     for _ in range(reg_count)]
        self._delta_cache: dict[int, torch.Tensor] = {}
        self._chain = tfs.chain_ok(self.t.fp)
        self._a_bufs: dict[int, torch.Tensor] = {}

    # -- helpers ----------------------------------------------------------
    def _zx(self):
        return torch.zeros(self._sh, dtype=torch.int64, device=self.device)

    def _zc(self):
        return torch.zeros(self.t.carry_shape, dtype=torch.int64,
                           device=self.device)

    def _settled(self, r: Reg) -> torch.Tensor:
        st = self.regs[r]
        assert not st[2], "spectral register used as digits"
        x = op_settle(self.t, st[0], st[1])
        self.regs[r] = [x, self._zc(), False]
        return x

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
        self.regs[dst] = [st[0].clone(), st[1].clone(), st[2]]

    def _chain_buf(self, a: list[int]):
        """K9's multipliers for one chunk: the list itself on the CPU; on
        the card a device buffer, kept per value for a constant chunk (the
        PRP chain's ones, a single x3) so the hot loop copies nothing to the
        device."""
        if self.device.type == "cpu":
            return a
        if any(v != a[0] for v in a):
            return tk.chain_multipliers(a, self.device)
        buf = self._a_bufs.get(a[0])
        if buf is None:
            buf = tk.chain_multipliers([a[0]] * tk.CHAIN_K, self.device)
            if len(self._a_bufs) < 8:
                self._a_bufs[a[0]] = buf
        return buf

    def square_mul(self, src: Reg, a: int = 1) -> None:
        self.square_mul_seq(src, [a])

    def square_mul_seq(self, src: Reg, a_vec) -> None:
        """K9 per chunk of CHAIN_K squarings where chain_ok holds, else one
        step per squaring: three kernels on the row carry, four on the
        block carry (with a = 1 K3 and K7 skip their multiplier)."""
        st = self.regs[src]
        assert not st[2], "spectral register used as digits"
        a = [int(v) for v in a_vec]
        t, x, co = self.t, st[0], st[1]
        if not self._chain:
            for ak in a:
                tk.square_step(t, x, co, a=ak, out=x, co_out=co)
            return
        kc = tk.CHAIN_K
        for off in range(0, len(a), kc):
            chunk = a[off:off + kc]
            tk.square_chain(t, x, co, self._chain_buf(chunk),
                            count=len(chunk), out=x, co_out=co)

    def square_sub2_seq(self, src: Reg, count: int) -> None:
        if not tfs.use_rowcarry(self.t.fp):
            super().square_sub2_seq(src, count)   # square, then sub
            return
        st = self.regs[src]
        assert not st[2], "spectral register used as digits"
        t, x, co = self.t, st[0], st[1]
        for _ in range(count):
            tk.square_step(t, x, co, sub2=True, out=x, co_out=co)

    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        st = self.regs[src]
        assert not st[2], "spectral register used as digits"
        u = tk.fwd_step(self.t, st[0], st[1])
        self.regs[dst] = [u, self._zc(), True]

    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        st = self.regs[dst]
        u = self.regs[src]
        assert u[2], "mul src must hold a multiplicand"
        assert not st[2], "mul dst must hold digits"
        tk.mul_step(self.t, st[0], st[1], u[0], a=int(a), out=st[0],
                    co_out=st[1])

    def add(self, dst: Reg, src: Reg) -> None:
        x = self._settled(dst)
        y = self._settled(src)
        self.regs[dst] = [op_linear(self.t, x, y, 1), self._zc(), False]

    def sub_reg(self, dst: Reg, src: Reg) -> None:
        x = self._settled(dst)
        y = self._settled(src)
        self.regs[dst] = [op_linear(self.t, x, y, -1), self._zc(), False]

    def _delta_vec(self, a: int) -> torch.Tensor:
        if a not in self._delta_cache:
            mp = (1 << self.p) - 1
            d = dg.int_to_digits(a % mp, self.widths)
            self._delta_cache[a] = gl.from_numpy_u64(d, self.device)
        return self._delta_cache[a]

    def sub(self, src: Reg, a: int) -> None:
        mp = (1 << self.p) - 1
        self.add_small(src, mp - (a % mp))

    def add_small(self, src: Reg, a: int) -> None:
        x = self._settled(src)
        self.regs[src] = [op_linear(self.t, x, x, 0, self._delta_vec(a)),
                          self._zc(), False]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host exchange ----------------------------------------------------
    def get_digits(self, src: Reg) -> np.ndarray:
        return gl.to_numpy_u64(self._settled(src)).reshape(self.n)

    def set_digits(self, dst: Reg, digits: np.ndarray) -> None:
        x = gl.from_numpy_u64(np.asarray(digits, dtype=np.uint64),
                              self.device).reshape(self._sh)
        self.regs[dst] = [x, self._zc(), False]

    def get_raw(self, src: Reg) -> np.ndarray:
        """Checkpoint dump: settled digits, or a multiplicand's spectral
        values (canonical mod P, flat (R1, R2, C) order: the JAX layout)."""
        st = self.regs[src]
        if st[2]:
            return gl.to_numpy_u64(gl.canon64(st[0])).reshape(self.n)
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
        u = gl.from_numpy_u64(np.asarray(data, dtype=np.uint64),
                              self.device).reshape(self._sh)
        self.regs[dst] = [u, self._zc(), True]
