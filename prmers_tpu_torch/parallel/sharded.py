"""The XLA-form mesh engine: a limb-sharded four-step NTT over the ranks.

Counterpart of prmers_tpu/parallel/sharded.py (ShardedEngineTables, the
local functions, psum_res64, ShardedSquareStep, ShardedEngine), the any-
shape fallback of the mesh: engine/factory.py takes it where
parallel/mesh_engine.MeshEngine does not take the shape (a plan below the
four-step engine's, s not dividing R2, the hybrid carry) and under
PRMERS_SHARDED_IMPL=xla. Per squaring, on s ranks of a group (the
reference's design, its lines 1-24):

  at rest:  digits (n,) sharded contiguously -> local rows block (dR, C)
  P1  local weights mul                         [R-sharded (dR, C)]
  A2A row->col reshard                          [(R, dC) C-sharded]
  P2  col_fwd over R (full R local)             + mid twiddle
  A2A transpose                                 [(C, dR) R-sharded]
  P3  col_fwd over C + dyadic square + col_inv over C
  T   local transpose                           [(dR, C) R-sharded]
  P4  mid-inverse twiddle
  A2A row->col reshard                          [(R, dC)]
  P5  col_inv over R + inverse weights
  A2A back to rest layout                       [(dR, C) -> (n/s,)]
  P6  carry: split, a ring of shift-and-add rounds whose wrap (last rank
      -> rank 0) is the mod-M_p fold, and the cyclic lookahead.

The register at rest is the rank's contiguous n/s digits, the same run of
the digit order MeshEngine's r1 shard holds, so parallel/shard_ckpt.py
treats both engines alike. A multiplicand is the rank's spectral (C, dR)
slice, flattened (the reference's layout: gathered, the ranks' slices one
after another).

Port: the reference's code with these changes.
  * One process per rank over parallel/dist in place of shard_map. The
    four lax.all_to_all are dist.to_r2_sharded ((dR, C) -> (R, dC); on the
    transposed (dC, R) it is the "A2A transpose" -> (C, dR)) and
    dist.to_r1_sharded ((R, dC) -> (dR, C)), each counted in dist.counts
    and timed by dist.time_collectives; the ppermute ring is
    dist.ring_prev, the lookahead's all_gather dist.all_gather_scalars,
    and psum_res64's psum an all_gather of each rank's two 32-bit partial
    sums (it returns a python int). A group of one runs no collective.
  * The transform runs the any-size engine's field (ops/gl64.TorchField,
    limbs in float64, engine/torch_engine.field) through ops/ntt.col_fwd
    and col_inv; a move carries canonical words (TorchField.lower before
    it, lift after).
  * The carry: the inverse's output is a canonical residue up to P - 1 >
    2^63 and torch's >> on int64 is arithmetic, so _carry_local splits on
    32-bit halves (ops/carry.carry_full's front) through the multiplier
    and the first round, and the remaining rounds and the lookahead are
    mesh_engine.ring_settle's (ops/carry._prefix_scan within the rank,
    the cyclic (G, P) fixpoint across the ranks). Its absorb rounds are
    those the operands' bound needs (ops/carry.absorb_rounds: 4 for a
    squaring at 19-bit digits, 1 for a linear op) where the reference
    runs a fixed 8, each round one message around the ring.
  * ShardedEngineTables builds only the rank's parts on the host (numpy,
    core.field.FieldOps): the weights' rows, the inverse weights' and the
    forward mid twiddles' columns, the inverse mid twiddles' rows, each
    power w^e from two power tables (rank_tables) in place of
    ntt.pow_by_exponents' bit loop over the whole of n. The field
    elements are the reference's (tests/test_torch_sharded.py holds them
    against NttTables.from_plan and _mid_full).
  * Registers are the rank's (reg_count, n/s) slab, int64 u64 patterns,
    with the spectral set of the reference's _spec. On a group of one on
    a card each op is a CUDA graph (engine/torch_engine.CudaGraphs), as
    in TorchEngine; with more ranks every op runs eagerly.
  * Engines take `device` (the group's card, or device="cpu").
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import field
from ..core.field import P, FieldOps
from ..core.plan import Plan, cached_plan
from ..engine.api import Engine, Reg
from ..engine.torch_engine import CudaGraphs
from ..engine.torch_engine import field as torch_field
from ..ops import carry as carry_ops
from ..ops import gl64 as gl
from ..ops import ntt
from ..utils import digits as dgu
from . import dist
from .mesh_engine import ring_settle

_M32 = 0xFFFFFFFF
_FNP = FieldOps(np)
_TABLES: dict = {}


def _powers_of(base: int, e: np.ndarray, bits: int) -> np.ndarray:
    """base^e mod P for u64 exponents e < 2^bits, canonical (the values of
    ntt.pow_by_exponents): base^(e mod 2^h) * (base^(2^h))^(e >> h) from
    two power tables of 2^h and 2^(bits - h) entries."""
    h = (bits + 1) // 2
    lo = _FNP.powers(base, 1 << h)
    hi = _FNP.powers(pow(base, 1 << h, P), 1 << max(bits - h, 0))
    return _FNP.mul(lo[e & np.uint64((1 << h) - 1)], hi[e >> np.uint64(h)])


def rank_tables(plan: Plan, s: int, rank: int) -> dict:
    """The host tables one rank of s reads (sharded.py:184-226), numpy u64:
    w_rc (dR, C) the weights' rows, iw_rc (R, dC) the inverse weights (x
    1/n) columns, mid_f (R, dC) and mid_i (dR, C) the materialized mid
    twiddles (_mid_full: omega_n^(freq_r[i] * j) and its inverse) by
    columns and rows, wid and msk (n/s,) the rank's digit widths and
    masks, stages_r and stages_c the replicated stage twiddles. ValueError
    where s does not divide R and C (sharded.py:205-207)."""
    p, n, R, C = plan.p, plan.n, plan.R, plan.C
    if R % s or C % s:
        raise ValueError(f"mesh size {s} must divide R={R} and C={C}")
    dR, dC = R // s, C // s
    bits = max(n.bit_length(), 1)
    rows = np.arange(rank * dR, (rank + 1) * dR, dtype=np.int64)
    cols = np.arange(rank * dC, (rank + 1) * dC, dtype=np.int64)
    nr2 = field.root_two_nth(n)
    pn = p % n

    def weight_exps(j):
        return ((-pn * j) % n).astype(np.uint64)

    w_rc = _powers_of(nr2, weight_exps(rows[:, None] * C + np.arange(C)),
                      bits)
    iw = _powers_of(field.inv(nr2),
                    weight_exps(np.arange(R)[:, None] * C + cols), bits)
    iw_rc = _FNP.mul(iw, np.uint64(plan.inv_n))
    wn = field.root_nth(n)
    freq = np.asarray(plan.freq_r, dtype=np.int64)
    mid_f = _powers_of(wn, ((freq[:, None] * cols) % n).astype(np.uint64),
                       bits)
    mid_i = _powers_of(field.inv(wn), ((freq[rows][:, None] *
                                        np.arange(C)) % n).astype(np.uint64),
                       bits)
    wid = plan.widths.astype(np.int64)[rank * n // s:(rank + 1) * n // s]
    return dict(w_rc=w_rc, iw_rc=iw_rc, mid_f=mid_f, mid_i=mid_i, wid=wid,
                msk=(np.int64(1) << wid) - 1,
                stages_r=ntt.build_stages(_FNP, plan.radixes_r, R),
                stages_c=ntt.build_stages(_FNP, plan.radixes_c, C))


class ShardedEngineTables:
    """A rank's tables on its device (sharded.py:184-226): the twiddles and
    weights lifted to the field's limbs, the widths and masks as int64.
    Built once per process per plan, world size, rank and device."""

    def __init__(self, p: int, device=None):
        self.plan = cached_plan(p)
        self.s, self.rank = dist.process_count(), dist.rank()
        self.R, self.C = self.plan.R, self.plan.C
        self.dR, self.dC = self.R // self.s, self.C // self.s
        self.device = dist.device(device)
        self.F = torch_field(self.device)
        self.wmin = int(self.plan.widths.min())
        self.wmax = int(self.plan.widths.max())
        key = (self.plan.p, self.plan.n, self.s, self.rank, str(self.device))
        if key not in _TABLES:
            _TABLES[key] = self._to_device(
                rank_tables(self.plan, self.s, self.rank))
        self.__dict__.update(_TABLES[key])

    def _to_device(self, h: dict) -> dict:
        lift = self.F.lift

        def put(a):
            return lift(gl.from_numpy_u64(np.ascontiguousarray(a),
                                          self.device))

        def stages(st):
            return [ntt.StageT(x.radix, put(x.tw), put(x.tw_inv))
                    for x in st]

        return dict(
            w_rc=put(h["w_rc"]), iw_rc=put(h["iw_rc"]),
            mid_f=put(h["mid_f"]), mid_i=put(h["mid_i"]),
            wid=torch.from_numpy(h["wid"]).to(self.device),
            msk=torch.from_numpy(h["msk"]).to(self.device),
            stages_r=stages(h["stages_r"]), stages_c=stages(h["stages_c"]))


def _a2a(tb: ShardedEngineTables, x, transpose: bool = False):
    """lax.all_to_all(x, 1, 0) on limbs (sharded.py:58-59): (dR, C) ->
    (R, dC); with transpose the move of x.T, (dC, R) -> (C, dR)."""
    if transpose:
        x = x.T
    if tb.s == 1:
        return x
    F = tb.F
    return F.lift(dist.to_r2_sharded(F.lower(x).contiguous()))


def _carry_local(tb: ShardedEngineTables, y: torch.Tensor, a: int = 1,
                 bound: int = 1 << 64) -> torch.Tensor:
    """Digit-contiguous carry of the rank's y (n/s,) times a, across the
    ring (sharded.py:62-119): y may hold any u64 pattern below bound, so
    the split and the first round go on 32-bit halves, then
    mesh_engine.ring_settle takes the rest of the absorb rounds that
    bound * a needs (ops/carry.absorb_rounds) and the lookahead."""
    wid, msk = tb.wid, tb.msk
    absorb = carry_ops.absorb_rounds(bound * a, tb.wmin)
    y0, y1 = y & _M32, (y >> 32) & _M32
    d = y0 & msk
    cl = ((y0 >> wid) | (y1 << (32 - wid))) & _M32
    ch = y1 >> wid
    if a != 1:
        t = d * a
        lo = cl * a + (t >> wid)
        cl = lo & _M32
        ch = ch * a + (lo >> 32)
        d = t & msk
    last = dist.ring_prev(torch.stack([cl[-1], ch[-1]]))
    lo = d + torch.cat([last[:1], cl[:-1]])
    d = lo & msk
    c = (lo >> wid) + (torch.cat([last[1:], ch[:-1]]) << (32 - wid))
    return ring_settle(c, d, wid, msk, absorb - 1)


def _fwd_local(tb: ShardedEngineTables, xd: torch.Tensor):
    """Forward transform of a digit shard -> the local spectral slice, (C,
    dR) limbs (sharded.py:122-134)."""
    F = tb.F
    x = F.mul(F.lift(xd.reshape(tb.dR, tb.C)), tb.w_rc)   # [R-sharded]
    x = _a2a(tb, x)                                       # (R, dC)
    x = ntt.col_fwd(F, x, tb.stages_r)
    x = F.mul(x, tb.mid_f)                                # mid twiddle
    x = _a2a(tb, x, transpose=True)                       # (C, dR)
    return ntt.col_fwd(F, x, tb.stages_c)


def _inv_local(tb: ShardedEngineTables, sd, a: int) -> torch.Tensor:
    """Spectral slice (C, dR) limbs -> the rank's digits, carried
    (sharded.py:137-152)."""
    F = tb.F
    x = ntt.col_inv(F, sd, tb.stages_c)
    x = F.mul(x.T, tb.mid_i)                              # (dR, C)
    x = _a2a(tb, x)                                       # (R, dC)
    x = ntt.col_inv(F, x, tb.stages_r)
    x = F.mul(x, tb.iw_rc)                                # x 1/n
    x = dist.to_r1_sharded(F.lower(x))                    # (dR, C) words
    return _carry_local(tb, x.reshape(-1), a)


def _square_local(tb: ShardedEngineTables, xd: torch.Tensor,
                  a: int = 1) -> torch.Tensor:
    """One squaring of the rank's digits, times a (sharded.py:155-161)."""
    return _inv_local(tb, tb.F.sqr(_fwd_local(tb, xd)), a)


def _mul_local(tb: ShardedEngineTables, xd: torch.Tensor, ud: torch.Tensor,
               a: int = 1) -> torch.Tensor:
    """dst * multiplicand(u) * a on the rank's shard; ud is the flat
    spectral slice _fwd_local made (sharded.py:164-172)."""
    F = tb.F
    sx = F.mul(_fwd_local(tb, xd), F.lift(ud.reshape(tb.C, tb.dR)))
    return _inv_local(tb, sx, a)


def _linear_local(tb: ShardedEngineTables, xd: torch.Tensor,
                  yd: torch.Tensor, coef_y: int,
                  const: torch.Tensor | None = None) -> torch.Tensor:
    """digits(x) + coef_y * digits_or_complement(y) + const with the carry
    ring (sharded.py:175-181)."""
    if coef_y < 0:
        b = tb.msk - yd
    elif coef_y == 0:
        b = torch.zeros_like(yd)
    else:
        b = yd
    y = xd + b if const is None else xd + b + const
    return _carry_local(tb, y, bound=3 << tb.wmax)


def psum_res64(tb: ShardedEngineTables, digits: torch.Tensor) -> int:
    """The low 64 bits of the value from the rank's digits, summed over the
    group (sharded.py:290-306): each digit at bit offset q < 64 adds
    d << q mod 2^64, as two 32-bit halves so that no int64 wraps."""
    q = np.concatenate([[0], np.cumsum(tb.plan.widths.astype(np.int64))])
    m = tb.plan.n // tb.s
    q = torch.from_numpy(q[tb.rank * m:(tb.rank + 1) * m]).to(digits.device)
    ip = q < 64
    low = q < 32
    sh = torch.where(low, q, q - 32).clamp(0, 31)
    v = torch.where(ip, digits.reshape(-1) << sh, 0)
    lo = torch.where(low, v & _M32, 0)
    hi = torch.where(low, v >> 32, v & _M32)
    part = torch.stack([lo.sum(), hi.sum()])
    tot = [int(t) for t in dist.all_gather_scalars(part).sum(0).tolist()]
    return (tot[0] + (tot[1] << 32)) & ((1 << 64) - 1)


class ShardedSquareStep:
    """One PRP squaring over the group (sharded.py:309-324): regs the rank's
    (reg_count, n/s) digits, step(src, a) squares register src times a."""

    def __init__(self, p: int, reg_count: int, device=None):
        self.tables = ShardedEngineTables(p, device=device)
        self.plan = self.tables.plan
        self.regs = torch.zeros((reg_count, self.plan.n // self.tables.s),
                                dtype=torch.int64, device=self.tables.device)

    def step(self, src: int = 0, a: int = 1) -> torch.Tensor:
        self.regs[src] = _square_local(self.tables, self.regs[src], int(a))
        return self.regs


class ShardedEngine(CudaGraphs, Engine):
    """Engine whose every register op runs through the ranks' local
    functions and moves (sharded.py:338-459); the host touches digits only
    for set/get exchange, which gathers through parallel/dist."""

    backend_name = "sharded"

    def __init__(self, p: int, reg_count: int, device=None):
        super().__init__(p, reg_count)
        self.tables = tb = ShardedEngineTables(p, device=device)
        self.plan = tb.plan
        self.n = self.plan.n
        self.device = tb.device
        self.mp = (1 << p) - 1
        self.regs = torch.zeros((reg_count, self.n // tb.s),
                                dtype=torch.int64, device=self.device)
        self._spec: set[int] = set()
        self._delta_cache: dict[int, torch.Tensor] = {}
        # collectives are not captured: graphs on a group of one only
        self.graphs = self.device.type == "cuda" and tb.s == 1
        self._graphs: dict = {}
        self._pool = None

    # -- helpers ----------------------------------------------------------
    def get_size(self) -> int:
        return self.n

    @property
    def widths(self) -> np.ndarray:
        return self.plan.widths

    def _local(self, data: np.ndarray) -> torch.Tensor:
        return gl.from_numpy_u64(
            dist.put_global(np.asarray(data, dtype=np.uint64)), self.device)

    def _delta_vec(self, a: int) -> torch.Tensor:
        if a not in self._delta_cache:
            self._delta_cache[a] = self._local(
                dgu.int_to_digits(a % self.mp, self.plan.widths))
        return self._delta_cache[a]

    def _op(self, key, dst: Reg, fn) -> None:
        """regs[dst] = fn(), through a CUDA graph where the engine takes
        them."""
        self._run(key, lambda: self.regs[dst].copy_(fn()))

    # -- hot path ---------------------------------------------------------
    def square_mul(self, src: Reg, a: int = 1) -> None:
        assert src not in self._spec
        a = int(a)
        self._op(("sqr", src, a), src,
                 lambda: _square_local(self.tables, self.regs[src], a))

    # -- register ops -----------------------------------------------------
    def set(self, dst: Reg, a: int) -> None:
        self.set_int(dst, a)

    def copy(self, dst: Reg, src: Reg) -> None:
        if dst != src:
            self.regs[dst].copy_(self.regs[src])
        if src in self._spec:
            self._spec.add(dst)
        else:
            self._spec.discard(dst)

    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        assert src not in self._spec
        tb = self.tables
        self._op(("fwd", dst, src), dst, lambda: tb.F.lower(
            _fwd_local(tb, self.regs[src])).reshape(-1))
        self._spec.add(dst)

    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        assert src in self._spec and dst not in self._spec
        a = int(a)
        self._op(("mul", dst, src, a), dst, lambda: _mul_local(
            self.tables, self.regs[dst], self.regs[src], a))

    def sub(self, src: Reg, a: int) -> None:
        self.add_small(src, self.mp - (a % self.mp))

    def add_small(self, src: Reg, a: int) -> None:
        vec = self._delta_vec(a)
        self._op(("add_small", src, a), src, lambda: _linear_local(
            self.tables, self.regs[src], self.regs[src], 0, vec))

    def add(self, dst: Reg, src: Reg) -> None:
        self._op(("add", dst, src), dst, lambda: _linear_local(
            self.tables, self.regs[dst], self.regs[src], 1))

    def sub_reg(self, dst: Reg, src: Reg) -> None:
        self._op(("sub_reg", dst, src), dst, lambda: _linear_local(
            self.tables, self.regs[dst], self.regs[src], -1))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- host exchange ----------------------------------------------------
    def get_digits(self, src: Reg) -> np.ndarray:
        assert src not in self._spec, "spectral register read as digits"
        return self.get_raw(src)

    def set_digits(self, dst: Reg, digits: np.ndarray) -> None:
        self.regs[dst].copy_(self._local(digits))
        self._spec.discard(dst)

    def get_raw(self, src: Reg) -> np.ndarray:
        return gl.to_numpy_u64(dist.global_gather(self.regs[src]))

    def get_raw_tagged(self, src: Reg) -> tuple[np.ndarray, bool]:
        return self.get_raw(src), src in self._spec

    def set_raw(self, dst: Reg, data: np.ndarray) -> None:
        self.set_digits(dst, data)

    def set_raw_tagged(self, dst: Reg, data: np.ndarray,
                       spectral: bool = False) -> None:
        self.set_raw(dst, data)
        if spectral:
            self._spec.add(dst)
