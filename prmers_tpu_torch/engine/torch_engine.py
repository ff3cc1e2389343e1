"""The any-size engine: the Engine register API on ops/ntt.py's transform,
in torch on any device.

Counterpart of prmers_tpu/engine/jax_engine.py (JaxEngine, JaxRowEngine),
op for op. It takes every plan core/plan.py makes (n = 2^k or 5 * 2^k from
8 up), so it is what create_engine hands out where the four-step kernel
engine (engine/fourstep_engine.py) does not take the plan: the small
exponents of the reference goldens (n = 8 at p = 127, 512 at 9941 and
11213, 4096 at 100003), the radix-5 band below 163840 and every p under
PRMERS_NO_PALLAS. As in the JAX package, it runs no hand-written kernel:
ntt.forward and ntt.inverse as they are, on ops/gl64.TorchField (limbs in
float64), and ops/carry.carry_full.

A register holds settled digits, or the spectral (C, R) words of a
multiplicand reshaped to n (jax_engine.py:76-80), as int64 tensors of u64
bit patterns. TorchEngine keeps them in one (reg_count, n) slab and writes
every result into its row; TorchRowEngine, from n = ROW_MODE_MIN_N, keeps
one (n,) tensor per register and never writes one in place, so `copy` may
alias. A squaring ends in the inverse's canonical digits (a lazy word >= P
would be another integer) and carry_full with a static round count
(carry.absorb_rounds), so no op of it waits on the host. On a card,
TorchEngine captures each op that runs on the device (squarings,
set_multiplicand, mul, add, sub_reg, addsub, sub, add_small) in a CUDA
graph at its first call, keyed by (op, registers, multiplier), and
replays it after (a squaring is hundreds of small launches, an add tens);
an engine's graphs share one memory pool (its first graph's), so each
pins no temporaries of its own (CudaGraphs, which engine/engine3161.py
shares). graphs=False keeps every op eager.
get_raw gives canonical values, so checkpoints cross with JaxEngine in
both directions; like JaxEngine it flags no register spectral in them
(its spectral layout is the register layout) and refuses one flagged so
(the four-step engine's (R1, R2, C) layout), which the PRP driver takes
as no checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import torchconf
from ..core.plan import Plan, cached_plan
from ..ops import carry as carry_ops
from ..ops import gl64 as gl
from ..ops import kernels as tk
from ..ops import ntt
from ..utils import digits as dg
from .api import Engine, Reg

ROW_MODE_MIN_N = 1 << 25

_TABLES_CACHE: dict = {}
_FIELDS: dict = {}


def field(device: torch.device) -> gl.TorchField:
    key = str(device)
    if key not in _FIELDS:
        _FIELDS[key] = gl.TorchField(device)
    return _FIELDS[key]


def get_tables(plan: Plan, device: torch.device,
               compact: bool = False) -> ntt.NttTables:
    """The transform tables on a device (cached): built on the host in
    numpy (NttTables.from_plan), moved as int64 (to_device), and the
    twiddles and weights lifted to the field's limbs. Compact: u8 widths
    and no masks (the row mode)."""
    key = (plan.p, plan.n, str(device), compact)
    if key not in _TABLES_CACHE:
        F = field(device)
        t = ntt.NttTables.from_plan(plan, np, compact_widths=compact)
        t = t.to_device(device)
        lift = F.lift
        _TABLES_CACHE[key] = dataclasses.replace(
            t,
            stages_r=[ntt.StageT(s.radix, lift(s.tw), lift(s.tw_inv))
                      for s in t.stages_r],
            stages_c=[ntt.StageT(s.radix, lift(s.tw), lift(s.tw_inv))
                      for s in t.stages_c],
            mid_t1=lift(t.mid_t1), mid_t2=lift(t.mid_t2),
            mid_t1_inv=lift(t.mid_t1_inv), mid_t2_inv=lift(t.mid_t2_inv),
            weights=lift(t.weights), inv_weights_n=lift(t.inv_weights_n))
    return _TABLES_CACHE[key]


# ---------------------------------------------------------------------------
# The ops' carry (jax_engine.py:37-101 and :273-334); TorchEngine's methods
# hold the transform
# ---------------------------------------------------------------------------

def _masks_of(t):
    if t.masks is not None:
        return t.masks
    return (1 << t.widths.to(torch.int64)) - 1


def _carry(t, y, a, rounds):
    return carry_ops.carry_full(y, t.widths, t.masks, a, rounds=rounds)


class CudaGraphs:
    """An engine's ops through CUDA graphs: the engine sets `graphs` (take
    them at all), `_graphs` (key -> (graph, the kernel launches it
    replays)) and `_pool` (None)."""

    def _run(self, key, fn) -> None:
        """fn(), through a CUDA graph where this engine takes them: the
        first call runs fn eagerly (the warm-up, and this call's result),
        then captures it; later calls replay the capture. Every capture
        after the first goes into the first one's memory pool: each
        graph's result lands in a register allocated outside the pool and
        the graphs replay one after another on one stream, so a capture
        may reuse the temporaries of those before it. The pool lives as
        long as the engine's graphs do. The kernel wrappers count their
        launches (ops/kernels.calls): a capture launches nothing and each
        replay launches what it recorded, so the capture's counts move to
        the replays."""
        if not self.graphs:
            fn()
            return
        hit = self._graphs.get(key)
        if hit is not None:
            hit[0].replay()
            for name, k in hit[1]:
                tk.calls[name] += k
            return
        fn()
        before = dict(tk.calls)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self._pool):
            fn()
        launched = [(name, k - before[name]) for name, k in tk.calls.items()
                    if k != before[name]]
        for name, k in launched:
            tk.calls[name] -= k
        if self._pool is None:
            self._pool = g.pool()
        self._graphs[key] = (g, launched)


class TorchEngine(CudaGraphs, Engine):
    def __init__(self, p: int, reg_count: int, plan: Plan | None = None,
                 device=None, graphs: bool | None = None):
        super().__init__(p, reg_count)
        self.plan = plan if plan is not None else cached_plan(p)
        self.device = torchconf.device(device)
        self.F = field(self.device)
        self.t = get_tables(self.plan, self.device,
                            compact=self._compact())
        n = self.plan.n
        self._alloc(n)
        self._sub_cache: dict[int, torch.Tensor] = {}
        self.graphs = self.device.type == "cuda" if graphs is None \
            else graphs
        self._graphs: dict = {}
        self._pool = None
        self._wmin = int(self.plan.widths.min())

    # -- storage (TorchRowEngine keeps one tensor per register) -----------
    def _compact(self) -> bool:
        return False

    def _alloc(self, n: int) -> None:
        self.regs = torch.zeros((self.reg_count, n), dtype=torch.int64,
                                device=self.device)

    def _get(self, r: Reg) -> torch.Tensor:
        return self.regs[r]

    def _put(self, r: Reg, v: torch.Tensor) -> None:
        self.regs[r].copy_(v)

    # -- the transform (BatchTorchEngine runs it on each lane) -------------
    def _fwd(self, x: torch.Tensor):
        """Digits -> the spectrum, (C, R) limbs."""
        return ntt.forward(self.F, self.t, self.F.lift(x))

    def _inv(self, s):
        """The spectrum -> the unnormalized convolution, (n,) limbs."""
        return ntt.inverse(self.F, self.t, s)

    def _square(self, x: torch.Tensor, a: int, rounds: int) -> torch.Tensor:
        F = self.F
        y = F.lower(self._inv(F.sqr(self._fwd(x))))
        return _carry(self.t, y, a, rounds)

    def _mul(self, x: torch.Tensor, m: torch.Tensor, a: int,
             rounds: int) -> torch.Tensor:
        F, t = self.F, self.t
        m = F.lift(m.reshape(m.shape[:-1] + (t.C, t.R)))
        y = F.lower(self._inv(F.mul(self._fwd(x), m)))
        return _carry(t, y, a, rounds)

    def _rounds(self, a: int) -> int:
        """Absorb rounds for a convolution times a (the bound of
        ntt.py:197-203, max_word * 9, for a <= 9)."""
        return carry_ops.absorb_rounds(self.plan.max_word * max(int(a), 9),
                                       self._wmin)

    def get_size(self) -> int:
        return self.plan.n

    @property
    def widths(self) -> np.ndarray:
        return self.plan.widths

    # -- ops --------------------------------------------------------------
    def set(self, dst: Reg, a: int) -> None:
        self.set_int(dst, a)

    def copy(self, dst: Reg, src: Reg) -> None:
        if dst != src:
            self._put(dst, self._get(src))

    def square_mul(self, src: Reg, a: int = 1) -> None:
        a = int(a)
        r = self._rounds(a)
        self._run(("sqr", src, a), lambda: self._put(
            src, self._square(self._get(src), a, r)))

    def square_mul_seq(self, src: Reg, a_vec: Sequence[int]) -> None:
        for a in a_vec:
            self.square_mul(src, a)

    def square_sub2_seq(self, src: Reg, count: int) -> None:
        t, r = self.t, self._rounds(1)
        delta = self._digits_vec((1 << self.p) - 3)

        def step():
            x = self._square(self._get(src), 1, r)
            self._put(src, _carry(t, x + delta, 1, r))

        for _ in range(count):
            self._run(("sub2", src), step)

    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        def op():
            x = self._get(src)
            self._put(dst, self.F.lower(self._fwd(x)).reshape(x.shape))

        self._run(("fwd", dst, src), op)

    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        a = int(a)
        r = self._rounds(a)
        self._run(("mul", dst, src, a), lambda: self._put(
            dst, self._mul(self._get(dst), self._get(src), a, r)))

    def add(self, dst: Reg, src: Reg) -> None:
        t, r = self.t, self._rounds(1)
        self._run(("add", dst, src), lambda: self._put(
            dst, _carry(t, self._get(dst) + self._get(src), 1, r)))

    def sub_reg(self, dst: Reg, src: Reg) -> None:
        t, r = self.t, self._rounds(1)
        self._run(("sub_reg", dst, src), lambda: self._put(
            dst, _carry(t, self._get(dst) + (_masks_of(t) - self._get(src)),
                        1, r)))

    def addsub(self, sum_out: Reg, diff_out: Reg, a: Reg, b: Reg) -> None:
        t, r = self.t, self._rounds(1)

        def op():
            x, y = self._get(a), self._get(b)
            s = _carry(t, x + y, 1, r)
            d = _carry(t, x + (_masks_of(t) - y), 1, r)
            self._put(sum_out, s)
            self._put(diff_out, d)

        self._run(("addsub", sum_out, diff_out, a, b), op)

    def _digits_vec(self, v: int) -> torch.Tensor:
        """Digits of v mod M_p on the device (cached per v; a graph reads
        it where it was at capture)."""
        if v not in self._sub_cache:
            mp = (1 << self.p) - 1
            self._sub_cache[v] = gl.from_numpy_u64(
                dg.int_to_digits(v % mp, self.widths), self.device)
        return self._sub_cache[v]

    def _add_vec(self, key, src: Reg, vec: torch.Tensor) -> None:
        t, r = self.t, self._rounds(1)
        self._run(key, lambda: self._put(
            src, _carry(t, self._get(src) + vec, 1, r)))

    def sub(self, src: Reg, a: int) -> None:
        mp = (1 << self.p) - 1
        self._add_vec(("sub", src, a), src, self._digits_vec(mp - a % mp))

    def add_small(self, src: Reg, a: int) -> None:
        self._add_vec(("add_small", src, a), src, self._digits_vec(a))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host exchange ----------------------------------------------------
    def get_digits(self, src: Reg) -> np.ndarray:
        return gl.to_numpy_u64(self._get(src))

    def set_digits(self, dst: Reg, digits: np.ndarray) -> None:
        self._put(dst, gl.from_numpy_u64(np.asarray(digits, dtype=np.uint64),
                                         self.device))

    def get_raw(self, src: Reg) -> np.ndarray:
        """Digits, or a multiplicand's spectral words, canonical mod P
        (digits are below P already)."""
        return gl.to_numpy_u64(gl.canon64(self._get(src)))

    def set_raw(self, dst: Reg, data: np.ndarray) -> None:
        self.set_digits(dst, data)


class TorchRowEngine(TorchEngine):
    """TorchEngine with one (n,) tensor per register (jax_engine.py:267-436):
    compact widths (u8, the masks derived per carry), no graphs, and every
    op makes a new tensor, so copy aliases registers safely."""

    def __init__(self, p: int, reg_count: int, plan: Plan | None = None,
                 device=None):
        super().__init__(p, reg_count, plan=plan, device=device,
                         graphs=False)

    def _compact(self) -> bool:
        return True

    def _alloc(self, n: int) -> None:
        zero = torch.zeros(n, dtype=torch.int64, device=self.device)
        self.rows = [zero for _ in range(self.reg_count)]

    def _get(self, r: Reg) -> torch.Tensor:
        return self.rows[r]

    def _put(self, r: Reg, v: torch.Tensor) -> None:
        self.rows[r] = v
