"""The port's radix-5 transforms (n = 5 * 2^k) on the CPU, against the JAX
package (its tables, and its Pallas kernels and PallasEngine in interpret
mode with PRMERS_NO_CHAIN=1) and against big-int.

At n = 5 * 2^k the r2 factor is L2 = 5 * 2^b and its DFT is a
natural-order Vandermonde matrix (mxu_dft.py:53-67); every other stage
keeps its power-of-two form. The JAX takes such plans from n = 163840 on,
at (R1, R2, C) = (32, 5, 1024); larger L2 come only with larger n, so the
kernel and table checks also run at synthetic plans with C cut to 256
(64, 10, 256) and (64, 20, 256), as tests/test_pallas_radix5_tiling.py
builds them, and K5 at L2 = 320 is held to a big-int DFT on a few columns
of a synthetic (64, 320, 256) plan. Inputs come from numpy seeds.

Tolerance: none. K1, K2, K4 forward and K5 agree with their Pallas twins
mod P (both sides are lazy, so after canon); K3, K4 inverse and K7 bit for
bit; the engines' values equal big-int exactly.
"""

import types

import numpy as np
import pytest
import torch

from prmers_tpu.core.field import P as GP
from prmers_tpu.core.plan import build_plan
from prmers_tpu.utils import digits as dg
from prmers_tpu.utils import gmp
from prmers_tpu_torch import convert
from prmers_tpu_torch.engine import factory
from prmers_tpu_torch.engine import fourstep_engine as fse
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk
from prmers_tpu_torch.parallel import mesh_engine as tme
from prmers_tpu_torch.parallel import sharded_kernels as sk
from test_torch_tables import _decode_lhs

# (R, C) of each plan: two synthetic ones, and the JAX's own at n = 163840
PLANS = {"64x10x256": (640, 256), "64x20x256": (1280, 256),
         "32x5x1024": (160, 1024)}
P_ENGINE = 3600001          # a prime whose plan is n = 163840, (32, 5, 1024)
BLOCK = tfs.Pipeline(rowcarry=False)
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


def _plans(R, C):
    """The JAX and the port plan of one (R, C) split of n = R * C."""
    from prmers_tpu.ops.pallas import fourstep as fs
    n = R * C
    p = int(n * 16.5) | 1
    plan = build_plan(p, n=n)
    jfp = fs.FourStepPlan(p=p, n=n, R=R, C=C, rs=fs.make_split(R),
                          cs=fs.make_split(C), widths=plan.widths,
                          max_word=plan.max_word)
    fp = tfs.FourStepPlan(p=p, n=n, R=R, C=C, rs=tfs.make_split(R),
                          cs=tfs.make_split(C), widths=plan.widths,
                          max_word=plan.max_word)
    return plan, jfp, fp


@pytest.fixture(scope="module", params=list(PLANS))
def both(request):
    """Both packages' tables at one radix-5 plan, and one set of inputs."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PRMERS_PALLAS_INTERPRET", "1")
    mp.setenv("PRMERS_NO_CHAIN", "1")
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    plan, jfp, fp = _plans(*PLANS[request.param])
    assert fp.rs.L2 % 5 == 0 and (fp.rs.freq == jfp.rs.freq).all()
    jt = fs.FourStepTables.build(jfp, np, G=8, lanes=128)
    fs.attach_mxu_tables(jt)
    fs.attach_fused_c_tables(jt)
    kn.attach_cinrow(jt)
    kt = tfs.build_tables(fp)
    rng = np.random.default_rng(fp.rs.L2)
    t = tk.DevTables.from_host(kt, "cpu")
    x = _digits(plan, rng).reshape(t.shape)
    co = rng.integers(0, 1 << 40, size=t.carry_shape, dtype=np.uint64)
    co[0, 0, 0] = (1 << 45) + 12345       # the last unit's wrap
    co[-1, -1, -1] = (1 << 46) - 1
    bco = rng.integers(0, 1 << 40, size=t.block_carry_shape,
                       dtype=np.uint64)
    bco[-1, 0] = (1 << 46) - 1
    y = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    u = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    yield types.SimpleNamespace(plan=plan, jfp=jfp, fp=fp, jt=jt, kt=kt,
                                kn=kn, t=t, x=x, co=co, bco=bco, y=y, u=u)
    mp.undo()


# ---------------------------------------------------------------------------
# tables and predicates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [5, 20, 80, 320])
def test_dft_matrix_matches_jax(L):
    """The natural-order Vandermonde of root_554(L), forward and
    inverse, as mxu_dft.dft_matrix builds it."""
    from prmers_tpu.ops.pallas import mxu_dft as mx
    for inverse in (False, True):
        assert (tfs.dft_matrix(L, inverse) == mx.dft_matrix(L, inverse)).all()


def test_n_sized_tables_match_jax(both):
    """mf, mi, the wrap residues, the per-unit spread tables and the
    widths."""
    got = convert.tables_from_jax(both.jt, both.kt.k)
    for name in ("mf", "mi", "er", "ec", "wt", "cum", "widths"):
        mine = getattr(both.kt, name)
        assert got[name].shape == mine.shape, name
        assert (got[name] == mine).all(), name


def test_folded_matrices_match_jax(both):
    """g2 (the r2 DFT), tri (its inverse with t_r_inv as row scales) and
    the r1 matrices, decoded from the JAX's int8 limb planes."""
    L1, L2 = both.fp.rs.L1, both.fp.rs.L2
    mxu = both.jt.mxu
    assert (_decode_lhs(mxu[f"g{L2}f"][0], L2) == both.kt.g2).all()
    assert (_decode_lhs(mxu["tr_inv"][0], L2) == both.kt.tri).all()
    assert (_decode_lhs(mxu["tr_fwd_w"][0], L1) == both.kt.k1_mats).all()
    assert (_decode_lhs(mxu["iw_inv"][0], L1) == both.kt.k3_mats).all()


def test_predicates_match_jax(both):
    kn, jfp, fp = both.kn, both.jfp, both.fp
    assert tfs.use_r2fold(fp) == kn.use_r2fold(jfp)
    assert tfs.fc_split(fp) == kn._fc_split(jfp)
    assert tfs.carry_ct(fp) == kn.carry_ct(jfp)
    assert tfs.use_rowcarry(fp) == kn.use_rowcarry(jfp, both.jt)
    assert tfs.chain_ok(fp) == kn.chain_ok(jfp, both.jt) is False
    assert both.kt.k == kn.cin_row_k(jfp)
    assert both.kt.rounds == kn._carry_rounds(jfp)


# ---------------------------------------------------------------------------
# kernels against their Pallas twins
# ---------------------------------------------------------------------------

def test_k1_matches_pallas(both):
    """K1 reads its carries unrolled; the JAX side gets them rolled."""
    import jax.numpy as jnp
    rolled = np.roll(both.co.reshape(-1), 1).reshape(both.co.shape)
    (x0, x1), (c0, c1) = convert.state_to_jax(both.x, rolled)
    r0, r1 = both.kn.p1_carry_pass(both.jfp, both.jt, jnp.asarray(x0),
                                   jnp.asarray(x1), jnp.asarray(c0),
                                   jnp.asarray(c1))
    mine = tk.p1_carry_pass(both.t, _t(both.x), _t(both.co))
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()


@pytest.mark.parametrize("mode", ["sqr", "fwd", "mul"])
def test_k2_matches_pallas(both, mode):
    """K2 (r2fold): the natural-order r2 DFT x mf, the C-transform with
    the mode, and the mirror back through tri."""
    ju = _jpair(both.u) if mode == "mul" else None
    r0, r1 = both.kn.fused_c_pass(both.jfp, both.jt, *_jpair(both.y), mode,
                                  u=ju, r2fold=True)
    u = _t(both.u) if mode == "mul" else None
    mine = tk.fused_c_pass(both.t, _t(both.y), mode, u=u)
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()


@pytest.mark.parametrize("which", ["p2", "p6"])
def test_k5_matches_pallas(both, which):
    f = both.kn._p2_pass if which == "p2" else both.kn._p6_pass
    r0, r1 = f(both.jfp, both.jt, *_jpair(both.y))
    mine = tk.axis1_pass(both.t, _t(both.y), which)
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()


@pytest.mark.parametrize("variant", ["a1", "a3", "sub2"])
def test_k3_matches_pallas(both, variant):
    """Digits and unit carries bit for bit, on K2's lazy output."""
    s = tk.p1_carry_pass(both.t, _t(both.x), _t(both.co))
    z = _canon(_np(tk.fused_mid(both.t, s, "sqr")))
    a = 3 if variant == "a3" else 1
    d0, d1, c0, c1 = both.kn.p7_carry_pass(
        both.jfp, both.jt, *_jpair(z), _ja(a), a == 1,
        sub2=(variant == "sub2") or None)
    d, co = tk.p7_carry_pass(both.t, _t(z), a=a, sub2=(variant == "sub2"))
    x2, co2 = convert.state_from_jax(d0, d1, c0, c1)
    assert (x2 == _np(d)).all() and (co2 == _np(co)).all()


def test_k4_matches_pallas(both):
    """K4 forward with the (R1, 1) block carries against the JAX's
    injection strip then _p1_pass (mod P); K4 inverse against _p7_pass
    (bit for bit)."""
    kn, jfp, jt = both.kn, both.jfp, both.jt
    j0, j1 = kn.inject_block_carries(jfp, *_jpair(both.x), *_jpair(both.bco))
    r0, r1 = kn._p1_pass(jfp, jt, j0, j1, wfold=True)
    mine = tk.axis0_pass(both.t, _t(both.x), False, co=_t(both.bco))
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()
    r0, r1 = kn._p7_pass(jfp, jt, *_jpair(both.y), wfold=True)
    assert (_u64(r0, r1) == _np(tk.axis0_pass(both.t, _t(both.y),
                                              True))).all()


@pytest.mark.parametrize("a", [1, 3])
def test_k7_matches_pallas(both, a):
    """K7 against kn.k4 on values below P: digits and (R1, 1) block
    carries bit for bit."""
    y = _canon(both.y)
    d0, d1, c0, c1 = both.kn.k4(both.jfp, both.jt, *_jpair(y), _ja(a),
                                a_is_one=(a == 1))
    d, co = tk.block_carry_pass(both.t, _t(y), a)
    assert (_u64(d0, d1) == _np(d)).all()
    assert (_u64(c0, c1) == _np(co)).all()


def test_k5_l2_320_closed_form():
    """K5 at L2 = 320 (the r2 factor of n = 5 * 2^22 and up), on a
    synthetic (64, 320, 256) plan: the port's plain P2/P6 equal a big-int
    natural-order DFT, x mf after and x mi before, with the twiddle t_r_inv
    in closed form, on a few columns. (The JAX tables at this size take
    minutes of CPU here; the closed form holds the same stage boundary.)"""
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import mxu_dft as mx
    _plan, jfp, fp = _plans(20480, 256)
    assert fp.shape == (64, 320, 256) and (fp.rs.freq == jfp.rs.freq).all()
    t = tk.DevTables.from_host(tfs.build_tables(fp), "cpu")
    rng = np.random.default_rng(320)
    x = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    p2 = _np(tk.axis1_pass(t, _t(x), "p2"))
    p6 = _np(tk.axis1_pass(t, _t(x), "p6"))
    Mf = mx.dft_matrix(320, False).astype(object)
    Mi = mx.dft_matrix(320, True).astype(object)
    mf, mi = _np(t.mf), _np(t.mi)
    wR = fs.root_554(fp.R)
    f1 = fp.rs.freq1
    for r1, c in ((0, 0), (9, 131), (63, 255)):
        col = x[r1, :, c].astype(object)
        want = (Mf.dot(col) % GP) * mf[r1, :, c].astype(object) % GP
        assert (_canon(p2[r1, :, c]).astype(object) == want).all()
        tri = np.array([pow(wR, -(int(f1[r1]) * k) % fp.R, GP)
                        for k in range(320)], dtype=object)
        y = col * mi[r1, :, c].astype(object) % GP
        want = Mi.dot(y) % GP * tri % GP
        assert (_canon(p6[r1, :, c]).astype(object) == want).all()


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _engine(p, pipe=tfs.Pipeline()):
    return fse.FourStepEngine(p, 4, device="cpu", pipe=pipe)


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


@pytest.mark.parametrize("env,pipe", [({}, tfs.Pipeline()),
                                      ({"PRMERS_NO_ROWCARRY": "1"}, BLOCK)])
def test_engine_matches_pallas_engine_and_bigint(monkeypatch, env, pipe):
    """FourStepEngine and the JAX PallasEngine at p = 3600001 (n = 163840,
    (32, 5, 1024)) on the row carry and on the block carry: the same
    unsettled state after the squarings (through convert.state_from_jax),
    and values equal to big-int."""
    from prmers_tpu.engine.pallas_engine import PallasEngine
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PRMERS_NO_CHAIN", "1")
    monkeypatch.delenv("PRMERS_NO_ROWCARRY", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = P_ENGINE
    mp = (1 << p) - 1
    plan = build_plan(p)
    j = PallasEngine(p, 4, plan=plan)
    e = _engine(p, pipe)
    assert e.t.shape == (32, 5, 1024) and not e._chain
    rng = np.random.default_rng(7 + len(env))
    v = int.from_bytes(rng.bytes(p // 8), "little") % mp
    w = int.from_bytes(rng.bytes(p // 8), "little") % mp
    jx, jc = convert.state_from_jax(*_ops(j, v, w))
    ex, ec = _ops(e, v, w)
    assert jc.shape == ec.shape == e.t.carry_shape
    assert (jx == ex.view(np.uint64)).all()
    assert (jc == ec.view(np.uint64)).all()
    x0 = v
    for a in (3, 1, 3):
        x0 = gmp.mulmod(x0, x0 * a, mp)
    ll = w
    for _ in range(2):
        ll = (gmp.mulmod(ll, ll, mp) - 2) % mp
    assert e.get_int(0) == j.get_int(0) == gmp.mulmod(x0, w * 3, mp)
    assert e.get_int(3) == j.get_int(3) == ll


def test_checkpoint_crosses_from_pallas_engine(monkeypatch):
    """A PallasEngine checkpoint with pending row carries and a spectral
    multiplicand loads into FourStepEngine at n = 163840, whose ops then
    go on to the big-int values."""
    from prmers_tpu.engine.pallas_engine import PallasEngine
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PRMERS_NO_CHAIN", "1")
    monkeypatch.delenv("PRMERS_NO_ROWCARRY", raising=False)
    p = P_ENGINE
    mp = (1 << p) - 1
    j = PallasEngine(p, 4, plan=build_plan(p))
    rng = np.random.default_rng(41)
    vals = [int.from_bytes(rng.bytes(p // 8), "little") % mp
            for _ in range(3)]
    for r, v in enumerate(vals):
        j.set(r, v)
    j.square_mul(0, 3)                  # pending (R1, R2, 128) carries
    vals[0] = gmp.mulmod(vals[0], vals[0] * 3, mp)
    j.set_multiplicand(3, 2)
    f = _engine(p)
    f.set_checkpoint(j.get_checkpoint())
    assert [f.get_int(r) for r in range(3)] == vals
    assert f.regs[3][2]
    f.mul(1, 3)
    f.square_mul(0)
    assert f.get_int(1) == gmp.mulmod(vals[1], vals[2], mp)
    assert f.get_int(0) == gmp.mulmod(vals[0], vals[0], mp)


# ---------------------------------------------------------------------------
# shapes, factory, mesh
# ---------------------------------------------------------------------------

def _eligible(n):
    """Does fourstep_engine.check_shape take n = 5 * 2^k (any exponent,
    since the shape rules read n only)?"""
    try:
        fp = tfs.FourStepPlan.from_plan(
            types.SimpleNamespace(p=0, n=n, widths=None, max_word=0))
        fse.check_shape(fp)
    except (AssertionError, NotImplementedError):
        return False
    return True


@pytest.mark.parametrize("logn", range(12, 28))
def test_check_shape_matches_pallas_eligible(logn, monkeypatch):
    """check_shape takes n = 5 * 2^logn exactly where the JAX
    _pallas_eligible's plan conditions do (its device test answered as a
    TPU would): 163840 <= n <= 5 * 2^25."""
    import jax
    from prmers_tpu.core import plan as jplan
    from prmers_tpu.engine import factory as jfactory
    n = 5 << logn
    monkeypatch.delenv("PRMERS_NO_PALLAS", raising=False)
    monkeypatch.setattr(jplan, "cached_plan", lambda p: types.SimpleNamespace(
        p=p, n=n, widths=None, max_word=0))
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [types.SimpleNamespace(platform="tpu")])
    assert _eligible(n) == jfactory._pallas_eligible(1) == \
        (5 << 15 <= n <= 5 << 25)


class _NoTables(Exception):
    pass


def test_create_engine_plans_the_100m_digit_class(monkeypatch):
    """p = 332192831 (n = 5 * 2^22): create_engine gives a FourStepEngine
    on (64, 320, 1024) with whole-row carry units (T = 1), K2 with r2fold,
    the row carry and no K9; the tables (seconds of CPU at this size) are
    not built here."""
    seen = []

    def no_tables(plan, device, pipe=tfs.Pipeline()):
        seen.append(fse.four_step_plan(plan, pipe))
        raise _NoTables

    monkeypatch.setattr(fse, "get_tables", no_tables)
    with pytest.raises(_NoTables):
        factory.create_engine(332192831, 2, device="cpu")
    fp, = seen
    assert fp.shape == (64, 320, 1024) and fp.n == 5 << 22
    assert tfs.carry_ct(fp) == 1024 and tfs.carry_tiles(fp) == 1
    assert tfs.use_r2fold(fp) and not tfs.fc_split(fp)
    assert tfs.use_rowcarry(fp) and not tfs.chain_ok(fp)


@pytest.mark.parametrize("p,shape,r2fold,split,ct", [
    (3600001, (32, 5, 1024), True, False, 1024),
    (6972593, (64, 5, 1024), True, False, 1024),
    (100000007, (64, 80, 1024), True, False, 1024),
    (200000033, (64, 160, 1024), True, False, 1024),
    (700000001, (64, 320, 2048), False, False, 2048),
    (2147483647, (64, 320, 8192), False, True, 4096),
])
def test_radix5_plans_pick_the_jax_branches(p, shape, r2fold, split, ct,
                                            monkeypatch):
    """The plans of the radix-5 bands: K2 up to 5 * 2^22, K5 + K6 +
    K5 from 5 * 2^23, the split C-transform with T = 2 at MM31; each
    branch as the JAX predicates pick it."""
    from prmers_tpu.core import plan as jplan
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    n = jplan.transform_size(p)
    fake = types.SimpleNamespace(p=p, n=n, widths=None, max_word=0)
    fp = fse.four_step_plan(fake, tfs.Pipeline())
    jfp = fs.FourStepPlan.from_plan(fake)
    assert n % 5 == 0
    assert fp.shape == shape == (jfp.rs.L1, jfp.rs.L2, jfp.C)
    assert tfs.use_r2fold(fp) == kn.use_r2fold(jfp) == r2fold
    assert tfs.fc_split(fp) == kn._fc_split(jfp) == split
    assert tfs.carry_ct(fp) == kn.carry_ct(jfp) == ct
    assert not tfs.chain_ok(fp)


def test_mesh_refuses_radix5():
    """The mesh takes n = 5 * 2^k on the terms of any plan (check_mesh: s
    dividing R1 = 64 and R2 = 320 at 5 * 2^22) and refuses a world size
    that does not divide them; mesh_eligible follows, and "sharded" gives
    MeshEngine at p = 3600001, (32, 5, 1024), on a group of one (the
    XLA-form ShardedEngine where the mesh refuses, as for any plan)."""
    fp = fse.four_step_plan(types.SimpleNamespace(
        p=332192831, n=5 << 22, widths=None, max_word=0),
        tfs.Pipeline(r2fold_max=0))
    assert fp.shape == (64, 320, 1024)
    for s in (1, 2, 4, 8, 64):
        sk.check_mesh(fp, s)
    for s in (3, 128):
        with pytest.raises(ValueError, match="must divide"):
            sk.check_mesh(fp, s)
    assert tme.mesh_eligible(P_ENGINE, 1)
    assert not tme.mesh_eligible(P_ENGINE, 2)      # R2 = 5
    e = factory.create_engine(P_ENGINE, 2, device="cpu", backend="sharded")
    assert type(e) is tme.MeshEngine and e.tables.t1.dft5_f is not None