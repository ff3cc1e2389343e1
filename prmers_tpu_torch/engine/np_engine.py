"""Numpy oracle engine — bit-exact host implementation of the Engine API.

Runs the same transform/carry code as the device engine but on numpy arrays.
This is the analog of the reference's CPU engine factory
(reference: include/marin/engine.h:302 create_cpu) and is the unit-test oracle.

Port: a copy of prmers_tpu/engine/np_engine.py, the "numpy" backend of
the port's create_engine. One change: the carry is ops/carry.carry_full_np
(the reference's numpy path of carry_full; the port's carry_full is the
torch one). It runs no torch op.
"""

from __future__ import annotations

import numpy as np

from ..core.field import FieldOps
from ..core.plan import Plan, cached_plan
from ..ops import carry as carry_ops
from ..ops import ntt
from .api import Engine, Reg

F = FieldOps(np)


class NumpyEngine(Engine):
    def __init__(self, p: int, reg_count: int, plan: Plan | None = None):
        super().__init__(p, reg_count)
        self.plan = plan if plan is not None else cached_plan(p)
        self.t = ntt.NttTables.from_plan(self.plan, np)
        n = self.plan.n
        self.regs = np.zeros((reg_count, n), dtype=np.uint64)
        self._sub_cache: dict[int, np.ndarray] = {}

    # -- helpers --------------------------------------------------------
    def get_size(self) -> int:
        return self.plan.n

    @property
    def widths(self) -> np.ndarray:
        return self.plan.widths

    def _carry(self, y, a=1):
        return carry_ops.carry_full_np(F, y, self.t.widths, self.t.masks, a)

    # -- ops ------------------------------------------------------------
    def set(self, dst: Reg, a: int) -> None:
        self.set_int(dst, a)

    def copy(self, dst: Reg, src: Reg) -> None:
        self.regs[dst] = self.regs[src]

    def square_mul(self, src: Reg, a: int = 1) -> None:
        x = ntt.forward(F, self.t, self.regs[src])
        y = ntt.inverse(F, self.t, F.sqr(x))
        self.regs[src] = self._carry(y, a)

    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        self.regs[dst] = ntt.forward(F, self.t, self.regs[src]).reshape(self.plan.n)

    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        x = ntt.forward(F, self.t, self.regs[dst])
        m = self.regs[src].reshape(self.t.C, self.t.R)
        y = ntt.inverse(F, self.t, F.mul(x, m))
        self.regs[dst] = self._carry(y, a)

    def _mp_minus(self, a: int) -> np.ndarray:
        if a not in self._sub_cache:
            from ..utils import digits as dg
            mp = (1 << self.p) - 1
            self._sub_cache[a] = dg.int_to_digits((mp - a) % mp, self.widths)
        return self._sub_cache[a]

    def sub(self, src: Reg, a: int) -> None:
        self.regs[src] = self._carry(self.regs[src] + self._mp_minus(a))

    def add_small(self, src: Reg, a: int) -> None:
        from ..utils import digits as dg
        delta = dg.int_to_digits(a, self.widths)
        self.regs[src] = self._carry(self.regs[src] + delta)

    def add(self, dst: Reg, src: Reg) -> None:
        self.regs[dst] = self._carry(self.regs[dst] + self.regs[src])

    def sub_reg(self, dst: Reg, src: Reg) -> None:
        # M_p - src is the ones'-complement of the digit vector (2^p-1 - src)
        comp = self.t.masks - self.regs[src]
        self.regs[dst] = self._carry(self.regs[dst] + comp)

    # -- host exchange ---------------------------------------------------
    def get_digits(self, src: Reg) -> np.ndarray:
        return self.regs[src].copy()

    def set_digits(self, dst: Reg, digits: np.ndarray) -> None:
        self.regs[dst] = digits.astype(np.uint64)

    def get_raw(self, src: Reg) -> np.ndarray:
        return self.regs[src].copy()

    def set_raw(self, dst: Reg, data: np.ndarray) -> None:
        self.regs[dst] = np.asarray(data, dtype=np.uint64).copy()
