"""The block-carry pipeline (K4, the C-transform, K4 inverse, K7) and the
canonical-digit hybrid (K4, the C-transform, K4 inverse, carry_full) of
the port, on the CPU against the JAX package in Pallas interpret mode and
against big-int.

The port picks them through ops/fourstep.Pipeline(rowcarry=False) and
Pipeline(xla_carry=True); the JAX side through its own switches
(PRMERS_NO_ROWCARRY, PRMERS_XLA_CARRY) or, for its steps, the (R1, 1)
carry shape it branches on. Inputs come from numpy seeds. Tolerance: none;
the arithmetic is exact, so K4 forward agrees mod P (both sides are lazy)
and everything else bit for bit: K4 inverse, K7's digits and (R1, 1)
block carries, K8's rule, carry_full, the steps and the engines' values.
At n = 2^17 (R2 = 2) K7's flat shift crosses rows. The CUDA kernels are
held against these plain versions on the card (test_torch_kernels.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from prmers_tpu.core.field import P as GP
from prmers_tpu.core.plan import build_plan
from prmers_tpu.utils import digits as dg
from prmers_tpu.utils import gmp
from prmers_tpu_torch import convert
from prmers_tpu_torch.engine import factory
from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine
from prmers_tpu_torch.ops import carry as tcarry
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk

BLOCK = tfs.Pipeline(rowcarry=False)
HYBRID = tfs.Pipeline(xla_carry=True)
_u64 = convert.from_pairs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side,
    and torch's thread pools in each of them would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _p_of(n):
    return int(n * 16.5) | 1


def _canon(a64):
    a64 = np.asarray(a64, dtype=np.uint64)
    return np.where(a64 >= np.uint64(GP), a64 - np.uint64(GP), a64)


def _t(a64):
    return tgl.from_numpy_u64(a64, "cpu")


def _np(x):
    return tgl.to_numpy_u64(x)


def _jpair(a64):
    import jax.numpy as jnp
    a0, a1 = convert.to_pairs(a64)
    return jnp.asarray(a0), jnp.asarray(a1)


def _ja(a):
    """The JAX kernels' small multiplier: a (1, 1) u32 pair."""
    import jax.numpy as jnp
    return (jnp.full((1, 1), np.uint32(a)), jnp.zeros((1, 1), jnp.uint32))


def _digits(plan, rng):
    mp = (1 << plan.p) - 1
    v = int.from_bytes(rng.bytes(plan.p // 8 + 1), "little") % mp
    return dg.int_to_digits(v, plan.widths)


def _residues(rng, shape):
    """Values in [0, P), some of them P - 1 and 2^63."""
    y = rng.integers(0, GP, size=shape, dtype=np.uint64)
    y.reshape(-1)[::97] = GP - 1
    y.reshape(-1)[5::211] = 1 << 63
    return y


@pytest.fixture(scope="module", params=[15, 17])
def both(request):
    """The JAX tables and the port's (block-carry pipeline) at one n, with
    one set of inputs."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PRMERS_PALLAS_INTERPRET", "1")
    import jax.numpy as jnp
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    n = 1 << request.param
    plan = build_plan(_p_of(n), n=n)
    fpj = fs.FourStepPlan.from_plan(plan)
    tj = fs.FourStepTables.build(fpj, jnp, G=8, lanes=128)
    fs.attach_mxu_tables(tj)
    fs.attach_fused_c_tables(tj)
    kn.attach_cinrow(tj)
    assert kn._wfold_ok(fpj, tj)
    t = tk.DevTables.from_host(
        tfs.build_tables(tfs.FourStepPlan.from_plan(plan, BLOCK)), "cpu")
    assert t.carry_shape == (t.shape[0], 1)
    rng = np.random.default_rng(request.param)
    x = _digits(plan, rng).reshape(t.shape)
    co = rng.integers(0, 1 << 40, size=t.carry_shape, dtype=np.uint64)
    co[-1, 0] = (1 << 46) - 1            # the last block's wrap to block 0
    co[3, 0] = (1 << 45) + 12345
    yield dict(plan=plan, fpj=fpj, tj=tj, kn=kn, t=t, x=x, co=co,
               y=_residues(rng, t.shape), u=_residues(rng, t.shape))
    mp.undo()


# ---------------------------------------------------------------------------
# predicates and tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,pipe", [
    ({}, tfs.Pipeline()),
    ({"PRMERS_NO_ROWCARRY": "1"}, BLOCK),
    ({"PRMERS_XLA_CARRY": "1"}, HYBRID),
])
def test_pipeline_predicates_match_jax(both, monkeypatch, env, pipe):
    """use_rowcarry, use_xla_carry and chain_ok under each switch, and the
    block spread tables, equal the JAX package's."""
    kn, fpj, tj = both["kn"], both["fpj"], both["tj"]
    monkeypatch.delenv("PRMERS_NO_CHAIN", raising=False)
    for k in ("PRMERS_NO_ROWCARRY", "PRMERS_XLA_CARRY"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fp = tfs.FourStepPlan.from_plan(both["plan"], pipe)
    assert tfs.use_rowcarry(fp) == kn.use_rowcarry(fpj, tj)
    assert tfs.use_xla_carry(fp) == kn.use_xla_carry(fpj)
    assert tfs.chain_ok(fp) == kn.chain_ok(fpj, tj)
    k, wt, cum = kn._cin_plan(fpj)
    bk, bwt, bcum = tfs.block_cin_plan(fp)
    assert bk == k and (bwt == wt).all() and (bcum == cum).all()


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def test_k4_forward_matches_p1(both):
    """K4 forward without carries (the hybrid's) against _p1_pass, and with
    the block carries against inject_block_carries then _p1_pass: K4 folds
    the JAX's XLA injection strip in, before its halve."""
    kn, fpj, tj, t = both["kn"], both["fpj"], both["tj"], both["t"]
    x, co = both["x"], both["co"]
    r0, r1 = kn._p1_pass(fpj, tj, *_jpair(x), wfold=True)
    mine = tk.axis0_pass(t, _t(x), False)
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()
    j0, j1 = kn.inject_block_carries(fpj, *_jpair(x), *_jpair(co))
    r0, r1 = kn._p1_pass(fpj, tj, j0, j1, wfold=True)
    mine = tk.axis0_pass(t, _t(x), False, co=_t(co))
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()
    inj = tk.inject_block_carries_plain(t, _t(x), _t(co))
    assert (_np(inj) == _u64(j0, j1)).all()


def test_k4_inverse_matches_p7(both):
    kn, fpj, tj, t = both["kn"], both["fpj"], both["tj"], both["t"]
    r0, r1 = kn._p7_pass(fpj, tj, *_jpair(both["y"]), wfold=True)
    mine = tk.axis0_pass(t, _t(both["y"]), True)
    assert (_u64(r0, r1) == _np(mine)).all()


@pytest.mark.parametrize("inverse", [False, True])
def test_k4_matches_lane_tiled_grid(both, monkeypatch, inverse):
    """With AXIS0_BUDGET_EL at n / 2 the JAX takes its 2-D lane-tiled grid
    (its C = 8192 form; 2^16 at n = 2^17); the port's one grid agrees."""
    kn, fpj, tj, t = both["kn"], both["fpj"], both["tj"], both["t"]
    monkeypatch.setattr(kn, "AXIS0_BUDGET_EL", fpj.n // 2)
    v = both["y"] if inverse else both["x"]
    f = kn._p7_pass if inverse else kn._p1_pass
    r0, r1 = f(fpj, tj, *_jpair(v), wfold=True)
    mine = _np(tk.axis0_pass(t, _t(v), inverse))
    want = _u64(r0, r1)
    if not inverse:
        mine, want = _canon(mine), _canon(want)
    assert (mine == want).all()


# ---------------------------------------------------------------------------
# K7, K8's rule, carry_full
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a", [1, 3])
def test_k7_matches_k4_kernel(both, a):
    """block_carry_plain against kn.k4 (a_is_one with a = 1) on values up
    to P - 1: digits and (R1, 1) carries bit for bit."""
    kn, fpj, tj, t = both["kn"], both["fpj"], both["tj"], both["t"]
    y = _canon(both["y"])
    d0, d1, c0, c1 = kn.k4(fpj, tj, *_jpair(y), _ja(a), a_is_one=(a == 1))
    d, co = tk.block_carry_pass(t, _t(y), a)
    assert co.shape == (t.shape[0], 1)
    assert (_u64(d0, d1) == _np(d)).all()
    assert (_u64(c0, c1) == _np(co)).all()


@pytest.mark.parametrize("a", [None, 3])
def test_k8_round_rule(both, a):
    """K8 is K7's body with its own round rule (split until the residual is
    at most 1): block_carry_plain with that rule equals
    sharded_pallas._k4_local on the whole unsharded array."""
    from prmers_tpu.parallel import sharded_pallas as sp
    fpj, tj, t = both["fpj"], both["tj"], both["t"]
    wmin = int(fpj.widths.min())
    rounds = 1                          # sharded_pallas.py:209-213
    while fpj.max_word * 4 >> (rounds * wmin) > 1:
        rounds += 1
    assert rounds > t.rounds
    y = _canon(both["y"])
    d0, d1, c0, c1 = sp._k4_local(fpj, *_jpair(y), tj.widths32,
                                  a=None if a is None else _ja(a))
    d, co = tk.block_carry_plain(t, _t(y), a or 1, rounds=rounds)
    assert (_u64(d0, d1) == _np(d)).all()
    assert (_u64(c0, c1) == _np(co)).all()


@pytest.mark.parametrize("a", [1, 3, 65535])
@pytest.mark.parametrize("kind", ["residues", "saturated"])
def test_carry_full_matches_jax(a, kind):
    """carry_full with a multiplier on u64 inputs (values at and above
    2^63, up to P - 1) and on a saturated run (masks - y after y = 0, plus
    one at digit 0: a 1 ripples all the way round)."""
    import jax.numpy as jnp
    from jax import lax
    from prmers_tpu.core.field import FieldOps
    from prmers_tpu.ops import carry as jcarry
    plan = build_plan(_p_of(1 << 15), n=1 << 15)
    w = plan.widths.astype(np.uint64)
    rng = np.random.default_rng(a)
    if kind == "residues":
        y = _residues(rng, w.shape)
    else:
        y = (np.uint64(1) << w) - np.uint64(1)
        y[0] += np.uint64(1)
    want = jcarry.carry_full(FieldOps(jnp), jnp.asarray(y),
                             jnp.asarray(w.astype(np.uint32)), None, a,
                             lax=lax)
    got = tcarry.carry_full(_t(y), torch.from_numpy(w.astype(np.int64)),
                            a=a)
    assert (np.asarray(want) == _np(got)).all()


def test_carry_full_refuses_wide_multipliers():
    w = torch.full((8,), 17, dtype=torch.int64)
    with pytest.raises(ValueError):
        tcarry.carry_full(torch.zeros(8, dtype=torch.int64), w, a=1 << 16)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _jax_step(kn, fpj, tj, op, x, co, u, a):
    import jax.numpy as jnp
    xj, cj = convert.state_to_jax(x, co)
    xj, cj = [jnp.asarray(v) for v in xj], [jnp.asarray(v) for v in cj]
    if op == "sqr":
        return kn.square_step(fpj, tj, *xj, *cj, _ja(a), a_is_one=(a == 1))
    if op == "mul":
        return kn.mul_step(fpj, tj, *xj, *_jpair(u), *cj, _ja(a))
    return kn.fwd_step(fpj, tj, *xj, *cj)


def _port_step(t, op, x, co, u, a):
    if op == "sqr":
        return tk.square_step(t, _t(x), _t(co), a=a)
    if op == "mul":
        return tk.mul_step(t, _t(x), _t(co), _t(u), a=a)
    return tk.fwd_step(t, _t(x), _t(co))


@pytest.mark.parametrize("op,a", [("sqr", 1), ("sqr", 3), ("mul", 3),
                                  ("fwd", 1)])
def test_block_steps_match_jax(both, op, a):
    """square_step, mul_step and fwd_step on (R1, 1) block carries: the
    JAX's inject + _p1_pass, _fused_mid, _p7_pass and k4 against the port's
    K4, fused_mid, K4 inverse and K7."""
    kn, fpj, tj, t = both["kn"], both["fpj"], both["tj"], both["t"]
    u = _canon(both["u"])
    got = _port_step(t, op, both["x"], both["co"], u, a)
    want = _jax_step(kn, fpj, tj, op, both["x"], both["co"], u, a)
    if op == "fwd":
        assert (_canon(_u64(*want)) == _canon(_np(got))).all()
        return
    assert (_u64(want[0], want[1]) == _np(got[0])).all()
    assert (_u64(want[2], want[3]) == _np(got[1])).all()


@pytest.mark.parametrize("both", [15], indirect=True)
@pytest.mark.parametrize("op,a", [("sqr", 3), ("mul", 1), ("fwd", 1)])
def test_hybrid_steps_match_jax(both, monkeypatch, op, a):
    """The canonical-digit hybrid against the JAX under PRMERS_XLA_CARRY at
    n = 2^15: digits bit for bit (normalized), the carries passed
    through."""
    kn, fpj, tj = both["kn"], both["fpj"], both["tj"]
    monkeypatch.setenv("PRMERS_XLA_CARRY", "1")
    t = tk.DevTables.from_host(tfs.build_tables(
        tfs.FourStepPlan.from_plan(both["plan"], HYBRID)), "cpu")
    u = _canon(both["u"])
    zero = np.zeros(t.carry_shape, dtype=np.uint64)
    got = _port_step(t, op, both["x"], zero, u, a)
    want = _jax_step(kn, fpj, tj, op, both["x"], zero, u, a)
    if op == "fwd":
        assert (_canon(_u64(*want)) == _canon(_np(got))).all()
        return
    assert (_u64(want[0], want[1]) == _np(got[0])).all()
    assert (_np(got[1]) == 0).all()
    w = both["plan"].widths.reshape(t.shape)
    assert (_np(got[0]) < (np.uint64(1) << w.astype(np.uint64))).all()


def test_sub2_needs_the_row_carry(both):
    t = both["t"]
    x = torch.zeros(t.shape, dtype=torch.int64)
    co = torch.zeros(t.carry_shape, dtype=torch.int64)
    with pytest.raises(ValueError):
        tk.square_step(t, x, co, sub2=True)
    with pytest.raises(ValueError):
        tk.block_carry_pass(t, x, out=x)


# ---------------------------------------------------------------------------
# engines, checkpoints, factory
# ---------------------------------------------------------------------------

N = 1 << 15
P_EXP = _p_of(N)
MP = (1 << P_EXP) - 1


def _ops(e, v, w):
    """square_mul_seq([3, 1, 3]), set_multiplicand + mul(.., 3) and two LL
    steps; returns the unsettled state of register 0 after the squarings."""
    e.set(0, v)
    e.set(1, w)
    e.set(3, w)
    e.square_mul_seq(0, [3, 1, 3])
    state = [np.array(a) for a in e.regs[0][:-1]]   # copies
    e.set_multiplicand(2, 1)
    e.mul(0, 2, 3)
    e.square_sub2_seq(3, 2)
    return state


def test_block_engine_matches_bigint_and_pallas_engine(monkeypatch):
    """FourStepEngine on the block-carry pipeline and the JAX PallasEngine
    under PRMERS_NO_ROWCARRY: the same unsettled state after the
    squarings, and values equal to big-int."""
    from prmers_tpu.engine.pallas_engine import PallasEngine
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PRMERS_NO_ROWCARRY", "1")
    plan = build_plan(P_EXP, n=N)
    j = PallasEngine(P_EXP, 4, plan=plan)
    e = FourStepEngine(P_EXP, 4, plan=plan, device="cpu", pipe=BLOCK)
    assert not j._rc and j._csh == (32, 1) and not j._chain
    assert e.t.carry_shape == (32, 1) and not e._chain
    rng = np.random.default_rng(53)
    v = int.from_bytes(rng.bytes(P_EXP // 8), "little") % MP
    w = int.from_bytes(rng.bytes(P_EXP // 8), "little") % MP
    jx, jc = convert.state_from_jax(*_ops(j, v, w))
    ex, ec = _ops(e, v, w)
    assert jc.shape == (32, 1)
    assert (jx == ex.view(np.uint64)).all()
    assert (jc == ec.view(np.uint64)).all()
    x0 = v
    for a in (3, 1, 3):
        x0 = gmp.mulmod(x0, x0 * a, MP)
    x0 = gmp.mulmod(x0, w * 3, MP)
    ll = w
    for _ in range(2):
        ll = (gmp.mulmod(ll, ll, MP) - 2) % MP
    assert e.get_int(0) == j.get_int(0) == x0
    assert e.get_int(3) == j.get_int(3) == ll


def test_hybrid_engine_matches_bigint():
    e = FourStepEngine(P_EXP, 4, plan=build_plan(P_EXP, n=N), device="cpu",
                       pipe=HYBRID)
    rng = np.random.default_rng(59)
    v = int.from_bytes(rng.bytes(P_EXP // 8), "little") % MP
    w = int.from_bytes(rng.bytes(P_EXP // 8), "little") % MP
    _ops(e, v, w)
    assert (_np(e.regs[0][1]) == 0).all()
    x0 = v
    for a in (3, 1, 3):
        x0 = gmp.mulmod(x0, x0 * a, MP)
    ll = w
    for _ in range(2):
        ll = (gmp.mulmod(ll, ll, MP) - 2) % MP
    assert e.get_int(0) == gmp.mulmod(x0, w * 3, MP)
    assert e.get_int(3) == ll


def test_checkpoints_cross_row_and_block():
    """A checkpoint of a row-carry engine with pending row carries and a
    multiplicand loads into a block-carry engine, and one with pending
    block carries loads back into a row-carry engine."""
    plan = build_plan(P_EXP, n=N)
    r = FourStepEngine(P_EXP, 4, plan=plan, device="cpu")
    rng = np.random.default_rng(61)
    vals = [int.from_bytes(rng.bytes(P_EXP // 8), "little") % MP
            for _ in range(3)]
    for i, v in enumerate(vals):
        r.set(i, v)
    r.square_mul(0, 3)
    vals[0] = gmp.mulmod(vals[0], vals[0] * 3, MP)
    r.set_multiplicand(3, 2)
    m = vals[2]
    b = FourStepEngine(P_EXP, 4, plan=plan, device="cpu", pipe=BLOCK)
    b.set_checkpoint(r.get_checkpoint())
    assert [b.get_int(i) for i in range(3)] == vals
    b.mul(1, 3)
    vals[1] = gmp.mulmod(vals[1], m, MP)
    b.square_mul(2, 3)                  # pending block carries
    vals[2] = gmp.mulmod(vals[2], vals[2] * 3, MP)
    dump = b.get_raw_tagged(2)
    assert not dump[1]
    f = FourStepEngine(P_EXP, 4, plan=plan, device="cpu")
    f.set_checkpoint(b.get_checkpoint())
    assert [f.get_int(i) for i in range(3)] == vals
    assert f.regs[3][2]
    f.mul(0, 3)
    assert f.get_int(0) == gmp.mulmod(vals[0], m, MP)


@pytest.mark.parametrize("env,pipe", [
    ({}, tfs.Pipeline()),
    ({"PRMERS_NO_ROWCARRY": "1"}, tfs.Pipeline(rowcarry=False)),
    ({"PRMERS_XLA_CARRY": "1"}, tfs.Pipeline(xla_carry=True)),
    ({"PRMERS_NO_CHAIN": "1"}, tfs.Pipeline(chain=False)),
])
def test_factory_reads_the_jax_switches(monkeypatch, env, pipe):
    for k in ("PRMERS_NO_ROWCARRY", "PRMERS_XLA_CARRY", "PRMERS_NO_CHAIN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert factory.pipeline_from_env() == pipe
    e = factory.create_engine(756839, 2, device="cpu")
    assert e.t.fp.pipe == pipe
    assert e.t.carry_shape == ((32, 1, 1) if pipe.rowcarry and
                               not pipe.xla_carry else (32, 1))
