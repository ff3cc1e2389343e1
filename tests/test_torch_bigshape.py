"""The port's big-shape branches on the CPU: the lane-tiled carry (K1/K3
with T > 1 carry units per row), the r2 passes alone (K5), the C-transform
without them (K6) and its split inverse half (K6b), against the JAX
package's Pallas kernels in interpret mode and against big-int.

At n = 2^25 and 2^26 (C = 8192) the JAX pipeline runs T = 2, K5 and the
split K6 "fwd" + K6b. Those shapes are too large for the CPU, so the same
branches are forced at small n, the JAX side through its environment
budgets (as tests/test_pallas_lanecarry.py and test_pallas_bigshape.py
do), the port through its ops/fourstep.Pipeline:

  t4        n = 2^16, (R1, R2, C) = (64, 1, 1024), carry budget 16384:
            T = 4 units of 256 digits (K1, K3; the C-transform is K2)
  synthetic n = 2^16, (64, 4, 256): K5 (L2 = 4), K6, K6b at ca = 2
  split_t2  n = 2^18, (64, 4, 1024): r2 passes as K5, the split
            C-transform, T = 2 (the 2^26 pipeline)
  k6_whole  n = 2^18: r2 passes as K5, K6 in one kernel

Tolerance: none. K1, K5, K6 and K6b must agree with their Pallas twins mod
P (both sides are lazy, so after canon); K3 gives the same digits and unit
carries bit for bit; the engines equal big-int exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from prmers_tpu.core.field import P as GP
from prmers_tpu.core.plan import build_plan, cached_plan
from prmers_tpu.utils import digits as dg
from prmers_tpu.utils import gmp
from prmers_tpu_torch import convert
from prmers_tpu_torch.engine.fourstep_engine import (FourStepEngine,
                                                     check_shape)
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk

N4 = 1 << 16
P4 = int(N4 * 16.3) | 1
CARRY4 = 16384
NS = 1 << 16
PS = int(NS * 16.4) | 1
RS, CS = 256, 256
N18 = 1 << 18
P18 = int(N18 * 16.3) | 1

PIPES = {
    "t4": (P4, N4, tfs.Pipeline(carry_max=CARRY4)),
    "split_t2": (P18, N18, tfs.Pipeline(r2fold_max=2048, carry_max=1 << 17,
                                        fc_split=True)),
    "k6_whole": (P18, N18, tfs.Pipeline(r2fold_max=2048)),
}

_u64 = convert.from_pairs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side,
    and torch's thread pools in each of them would oversubscribe the
    cores (a test of 2 s alone took minutes)."""
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


def _digits(plan, rng):
    mp = (1 << plan.p) - 1
    v = int.from_bytes(rng.bytes(plan.p // 8 + 1), "little") % mp
    return dg.int_to_digits(v, plan.widths)


def _jax_env(mp, carry=None):
    mp.setenv("PRMERS_PALLAS_INTERPRET", "1")
    mp.setenv("PRMERS_NO_CHAIN", "1")
    if carry is not None:
        mp.setenv("PRMERS_CARRY_BUDGET", str(carry))


def _jax_tables(fp):
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    t = fs.FourStepTables.build(fp, np, G=8, lanes=128)
    fs.attach_mxu_tables(t)
    fs.attach_fused_c_tables(t)
    kn.attach_cinrow(t)
    return t


def _synthetic_plans(p, n, R, C):
    """The JAX and the port plan of one (R, C) split of n."""
    from prmers_tpu.ops.pallas import fourstep as fs
    plan = build_plan(p, n=n)
    jfp = fs.FourStepPlan(p=p, n=n, R=R, C=C, rs=fs.make_split(R),
                          cs=fs.make_split(C), widths=plan.widths,
                          max_word=plan.max_word)
    pfp = tfs.FourStepPlan(p=p, n=n, R=R, C=C, rs=tfs.make_split(R),
                           cs=tfs.make_split(C), widths=plan.widths,
                           max_word=plan.max_word)
    return jfp, pfp


# ---------------------------------------------------------------------------
# plans and predicates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["t4", "split_t2", "k6_whole",
                                  "p600000001", "p1000000007"])
def test_pipeline_matches_jax_predicates(case, monkeypatch):
    """The Pipeline budgets pick the same branches as the JAX package's
    environment budgets, and cin_row_k / carry_rounds agree per unit."""
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    if case in PIPES:
        p, n, pipe = PIPES[case]
        plan = build_plan(p, n=n)
    else:
        pipe = tfs.Pipeline()
        plan = cached_plan(int(case[1:]))
    monkeypatch.setenv("PRMERS_R2FOLD_BUDGET", str(pipe.r2fold_max))
    monkeypatch.setenv("PRMERS_CARRY_BUDGET", str(pipe.carry_max))
    if pipe.fc_split:
        monkeypatch.setenv("PRMERS_FC_SPLIT", "1")
    else:
        monkeypatch.delenv("PRMERS_FC_SPLIT", raising=False)
    jfp = fs.FourStepPlan.from_plan(plan)
    fp = tfs.FourStepPlan.from_plan(plan, pipe)
    assert (fp.rs.L1, fp.rs.L2, fp.C) == (jfp.rs.L1, jfp.rs.L2, jfp.C)
    assert tfs.use_r2fold(fp) == kn.use_r2fold(jfp)
    assert tfs.fc_split(fp) == kn._fc_split(jfp)
    assert tfs.carry_ct(fp) == kn.carry_ct(jfp)
    assert tfs.carry_tiles(fp) == kn.carry_tiles(jfp)
    assert tfs.cin_row_k(fp) == kn.cin_row_k(jfp)
    assert tfs.carry_rounds(fp) == kn._carry_rounds(jfp)
    check_shape(fp)


@pytest.mark.parametrize("p,shape,r2fold", [
    (600000001, (64, 64, 8192), True),
    (1000000007, (64, 128, 8192), False),
])
def test_big_exponents_take_the_split_pipeline(p, shape, r2fold):
    """create_engine's plans for p = 600000001 (n = 2^25) and 1000000007
    (n = 2^26): C = 8192, T = 2 carry units of 4096 digits, the split
    C-transform (so K5 + K6 "fwd" + K6b + K5, r2fold or not)."""
    fp = tfs.FourStepPlan.from_plan(cached_plan(p))
    assert (fp.rs.L1, fp.rs.L2, fp.C) == shape
    assert tfs.carry_tiles(fp) == 2 and tfs.carry_ct(fp) == 4096
    assert tfs.fc_split(fp) and tfs.use_r2fold(fp) == r2fold
    check_shape(fp)


def test_split_t2_spread_tables_match_jax(monkeypatch):
    """wt/cum per carry unit (T = 2) equal the JAX cinrow tables with
    their 128-lane padding per unit taken off (kernels.py:702-726)."""
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    p, n, pipe = PIPES["split_t2"]
    monkeypatch.setenv("PRMERS_CARRY_BUDGET", str(pipe.carry_max))
    plan = build_plan(p, n=n)
    k, wt, cum = kn._row_cin_plan(fs.FourStepPlan.from_plan(plan))
    mk, mwt, mcum = tfs.row_cin_plan(tfs.FourStepPlan.from_plan(plan, pipe))
    assert mk == k and mwt.shape == (64, 4, 2, k)
    assert (wt.reshape(64, 4, 2, 128)[..., :k] == mwt).all()
    assert (cum.reshape(64, 4, 2, 128)[..., :k] == mcum).all()
    assert (wt.reshape(64, 4, 2, 128)[..., k:] == 0).all()


def _decode_rhs(w8):
    """(.., 1024, 1024) JAX int8 planes -> (.., 128, 128) u64 mod P: limb
    0 of each contraction row, the eight balanced planes times 256^m."""
    out = sum(w8[..., 0:128, m * 128:(m + 1) * 128].astype(np.int64)
              .astype(object) * (256 ** m) for m in range(8))
    return (out % GP).astype(np.uint64)


def test_ca64_slot_matrices_match_jax():
    """Mf/Mi at ca_count = 64 (C = 8192), a few slots decoded from the
    JAX int8 planes (R = 32 rows, the fewest the fused tables take, keep
    the build small)."""
    from prmers_tpu.ops.pallas import fourstep as fs
    n, C = 1 << 18, 8192
    jfp, pfp = _synthetic_plans(int(n * 16.3) | 1, n, n // C, C)
    t = fs.FourStepTables.build(jfp, np, G=8, lanes=128)
    fs.attach_fused_c_tables(t)
    Mf, Mi, _wf, _wi = tfs.fused_c_mats(pfp)
    assert Mf.shape == (64, 128, 128)
    wf8, _cf, wi8, _ci = t.fused[:4]
    slots = [0, 1, 37, 63]
    assert (_decode_rhs(np.asarray(wf8)[slots]) == Mf[slots]).all()
    assert (_decode_rhs(np.asarray(wi8)[slots]) == Mi[slots]).all()


def test_k5_l2_128_closed_form():
    """K5 at L2 = 128 (the n = 2^26 row split), on a synthetic (64, 128,
    256) plan: the port's plain P2/P6 equal a big-int DFT in the JAX DIF
    order (mxu_dft.dft_matrix) with the twiddle t_r_inv in closed form, on
    a few columns. (The JAX _axis1_pass at L2 = 128 needs tables that take
    ~30 s of CPU here; the closed form holds the same stage boundary.)"""
    from prmers_tpu.core import field
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import mxu_dft as mx
    n = 1 << 21
    jfp, fp = _synthetic_plans(int(n * 16.2) | 1, n, 8192, 256)
    assert fp.rs.L2 == 128
    assert (fp.rs.freq == jfp.rs.freq).all()
    t = tk.DevTables.from_host(tfs.build_tables(fp), "cpu")
    rng = np.random.default_rng(41)
    x = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    p2 = _np(tk.axis1_pass(t, _t(x), "p2"))
    p6 = _np(tk.axis1_pass(t, _t(x), "p6"))
    Mf = mx.dft_matrix(128, False).astype(object)
    Mi = mx.dft_matrix(128, True).astype(object)
    mf, mi = _np(t.mf), _np(t.mi)
    wR = fs.root_554(fp.R)
    f1 = fp.rs.freq1
    for r1, c in ((0, 0), (5, 17), (63, 255)):
        col = x[r1, :, c].astype(object)
        want = (Mf.dot(col) % GP) * mf[r1, :, c].astype(object) % GP
        assert (_canon(p2[r1, :, c]).astype(object) == want).all()
        tri = np.array([pow(wR, -(int(f1[r1]) * k) % fp.R, GP)
                        for k in range(128)], dtype=object)
        y = col * mi[r1, :, c].astype(object) % GP
        want = Mi.dot(y) % GP * tri % GP
        assert (_canon(p6[r1, :, c]).astype(object) == want).all()
    assert field.P == GP


# ---------------------------------------------------------------------------
# kernels against their Pallas twins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def t4():
    """Both packages at the t4 shape, and one set of inputs."""
    mp = pytest.MonkeyPatch()
    _jax_env(mp, CARRY4)
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    p, n, pipe = PIPES["t4"]
    plan = build_plan(p, n=n)
    jfp = fs.FourStepPlan.from_plan(plan)
    jt = _jax_tables(jfp)
    assert kn.carry_tiles(jfp) == 4 and kn.use_rowcarry(jfp, jt)
    t = tk.DevTables.from_host(tfs.build_tables(
        tfs.FourStepPlan.from_plan(plan, pipe)), "cpu")
    assert t.carry_shape == (64, 1, 4) and t.ct == 256
    rng = np.random.default_rng(7)
    x = _digits(plan, rng).reshape(t.shape)
    co = rng.integers(0, 1 << 40, size=t.carry_shape, dtype=np.uint64)
    co[0, 0, 0] = (1 << 45) + 12345       # the last unit's wrap
    co[-1, -1, -1] = (1 << 46) - 1
    co[7, 0, 2] = (1 << 46) + 3
    yield dict(jfp=jfp, jt=jt, kn=kn, t=t, x=x, co=co)
    mp.undo()


def test_t4_tables_match_jax(t4):
    """The n-sized tables and the per-unit spread tables (T = 4) equal the
    JAX ones (convert.tables_from_jax takes the unit padding off)."""
    t = t4["t"]
    got = convert.tables_from_jax(t4["jt"], t.k)
    for name in ("mf", "mi", "er", "ec", "wt", "cum", "widths"):
        mine = _np(getattr(t, name)) if name in ("mf", "mi") else \
            getattr(t, name).numpy().astype(np.uint32)
        assert got[name].shape == mine.shape, name
        assert (got[name] == mine).all(), name


def test_k1_t4_matches_pallas(t4):
    import jax.numpy as jnp
    t, kn = t4["t"], t4["kn"]
    rolled = np.roll(t4["co"].reshape(-1), 1).reshape(t.carry_shape)
    (x0, x1), (c0, c1) = convert.state_to_jax(t4["x"], rolled)
    assert c0.shape == (64, 1, 4 * 128)
    r0, r1 = kn.p1_carry_pass(t4["jfp"], t4["jt"], jnp.asarray(x0),
                              jnp.asarray(x1), jnp.asarray(c0),
                              jnp.asarray(c1))
    mine = tk.p1_carry_pass(t, _t(t4["x"]), _t(t4["co"]))
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()


@pytest.mark.parametrize("variant", ["a1", "a3", "sub2"])
def test_k3_t4_matches_pallas(t4, variant):
    """Digits and unit carries bit for bit; sub2 subtracts only at unit 0,
    digit 0 (the 2-D grid predicate, kernels.py:862)."""
    import jax.numpy as jnp
    t, kn = t4["t"], t4["kn"]
    s = tk.p1_carry_pass(t, _t(t4["x"]), _t(t4["co"]))
    z = _canon(_np(tk.fused_mid(t, s, "sqr")))
    z0, z1 = convert.to_pairs(z)
    a = 3 if variant == "a3" else 1
    ap = (jnp.full((1, 1), np.uint32(a)), jnp.zeros((1, 1), jnp.uint32))
    d0, d1, co0, co1 = kn.p7_carry_pass(
        t4["jfp"], t4["jt"], jnp.asarray(z0), jnp.asarray(z1), ap, a == 1,
        sub2=(variant == "sub2") or None)
    d, co = tk.p7_carry_pass(t, _t(z), a=a, sub2=(variant == "sub2"))
    assert co.shape == (64, 1, 4)
    assert (_u64(d0, d1) == _np(d)).all()
    x2, co2 = convert.state_from_jax(d0, d1, co0, co1)
    assert (co2 == _np(co)).all() and (x2 == _np(d)).all()


@pytest.fixture(scope="module")
def synthetic():
    mp = pytest.MonkeyPatch()
    _jax_env(mp)
    from prmers_tpu.ops.pallas import kernels as kn
    jfp, fp = _synthetic_plans(PS, NS, RS, CS)
    jt = _jax_tables(jfp)
    t = tk.DevTables.from_host(tfs.build_tables(fp), "cpu")
    assert t.shape == (64, 4, 256)
    rng = np.random.default_rng(13)
    x = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    u = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    yield dict(jfp=jfp, jt=jt, kn=kn, t=t, x=x, u=u)
    mp.undo()


def _jpair(a64):
    import jax.numpy as jnp
    a0, a1 = convert.to_pairs(a64)
    return jnp.asarray(a0), jnp.asarray(a1)


@pytest.mark.parametrize("which", ["p2", "p6"])
def test_k5_matches_pallas(synthetic, which):
    sy, kn = synthetic, synthetic["kn"]
    f = kn._p2_pass if which == "p2" else kn._p6_pass
    r0, r1 = f(sy["jfp"], sy["jt"], *_jpair(sy["x"]))
    mine = tk.axis1_pass(sy["t"], _t(sy["x"]), which)
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()


@pytest.mark.parametrize("mode", ["sqr", "fwd", "mul"])
def test_k6_matches_pallas(synthetic, mode):
    sy, kn = synthetic, synthetic["kn"]
    ju = _jpair(sy["u"]) if mode == "mul" else None
    r0, r1 = kn.fused_c_pass(sy["jfp"], sy["jt"], *_jpair(sy["x"]), mode,
                             u=ju, r2fold=False)
    u = _t(sy["u"]) if mode == "mul" else None
    mine = tk.fused_c_pass(sy["t"], _t(sy["x"]), mode, u=u, r2fold=False)
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()


@pytest.mark.parametrize("op", ["sqr", "mul"])
def test_k6b_matches_pallas(synthetic, op):
    """K6b on what K6 "fwd" writes (the JAX split pipeline's seam)."""
    sy, kn = synthetic, synthetic["kn"]
    t = sy["t"]
    v = _canon(_np(tk.fused_c_pass(t, _t(sy["x"]), "fwd", r2fold=False)))
    ju = _jpair(sy["u"]) if op == "mul" else None
    r0, r1 = kn.fused_c_pass(sy["jfp"], sy["jt"], *_jpair(v), "invh_" + op,
                             u=ju)
    u = _t(sy["u"]) if op == "mul" else None
    mine = tk.fused_c_invh_pass(t, _t(v), op, u=u)
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()


def test_fused_mid_branches_agree(synthetic):
    """fused_mid under each Pipeline (K2; K5 + K6 + K5; K5 + K6 "fwd" +
    K6b + K5) gives one value mod P in every mode."""
    sy = synthetic
    fp0 = sy["t"].fp
    outs = {}
    for name, pipe in (("k2", tfs.Pipeline()),
                       ("k6", tfs.Pipeline(r2fold_max=512)),
                       ("split", tfs.Pipeline(fc_split=True))):
        fp = dataclasses.replace(fp0, pipe=pipe)
        t = dataclasses.replace(sy["t"], fp=fp)
        for mode in ("sqr", "mul", "fwd"):
            u = _t(sy["u"]) if mode == "mul" else None
            outs[name, mode] = _canon(_np(tk.fused_mid(t, _t(sy["x"]), mode,
                                                       u)))
    for mode in ("sqr", "mul", "fwd"):
        assert (outs["k2", mode] == outs["k6", mode]).all()
        assert (outs["k2", mode] == outs["split", mode]).all()


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(PIPES))
def test_engine_matches_bigint(case):
    """Squarings with x3 steps, set_multiplicand + mul, an LL sub2 chain
    and a settle of pending unit carries, under each forced pipeline."""
    p, n, pipe = PIPES[case]
    mp = (1 << p) - 1
    e = FourStepEngine(p, 4, plan=build_plan(p, n=n), device="cpu",
                       pipe=pipe)
    rng = np.random.default_rng(len(case))
    v = int.from_bytes(rng.bytes(p // 8), "little") % mp
    w = int.from_bytes(rng.bytes(p // 8), "little") % mp
    e.set(0, v)
    e.set(1, w)
    want = v
    for a in (1, 3, 1):
        e.square_mul(0, a)
        want = gmp.mulmod(want, want * a, mp)
    e.set_multiplicand(2, 1)
    e.mul(0, 2, 3)
    want = gmp.mulmod(want, w * 3, mp)
    assert e.get_int(0) == want
    e.set(3, w)
    e.square_sub2_seq(3, 3)
    ll = w
    for _ in range(3):
        ll = (gmp.mulmod(ll, ll, mp) - 2) % mp
    assert e.get_int(3) == ll


@pytest.fixture(scope="module")
def jax_t4_engine():
    mp = pytest.MonkeyPatch()
    _jax_env(mp, CARRY4)
    from prmers_tpu.engine.pallas_engine import PallasEngine
    from prmers_tpu.ops.pallas import kernels as kn
    p = int(N4 * 16.1) | 1                # a plan of its own in the cache
    e = PallasEngine(p, 4, plan=build_plan(p, n=N4))
    assert e._rc and not e._chain and e._csh == (64, 1, 4 * 128)
    assert kn.carry_tiles(e.fp) == 4
    yield e
    mp.undo()


def test_checkpoints_cross_with_t4(jax_t4_engine):
    """FourStepEngine (T = 4) -> PallasEngine (T = 4) and back: settled
    values, a carried multiplicand, and pending unit carries on each side
    when the checkpoint is taken."""
    j = jax_t4_engine
    p = j.p
    mp = (1 << p) - 1
    e = FourStepEngine(p, 4, plan=build_plan(p, n=N4), device="cpu",
                       pipe=tfs.Pipeline(carry_max=CARRY4))
    assert e.t.carry_shape == (64, 1, 4)
    rng = np.random.default_rng(43)
    vals = [int.from_bytes(rng.bytes(p // 8), "little") % mp
            for _ in range(3)]
    for r, v in enumerate(vals):
        e.set(r, v)
    e.square_mul(0, 3)                  # pending unit carries
    vals[0] = gmp.mulmod(vals[0], vals[0] * 3, mp)
    e.set_multiplicand(3, 2)
    j.set_checkpoint(e.get_checkpoint())
    for r in range(3):
        assert j.get_int(r) == vals[r], r
    j.mul(1, 3)                         # JAX pending (R1, R2, 4*128) carries
    vals[1] = gmp.mulmod(vals[1], vals[2], mp)
    f = FourStepEngine(p, 4, plan=build_plan(p, n=N4), device="cpu",
                       pipe=tfs.Pipeline(carry_max=CARRY4))
    f.set_checkpoint(j.get_checkpoint())
    assert [f.get_int(r) for r in range(3)] == vals
    assert f.regs[3][2]
    f.mul(0, 3)
    assert f.get_int(0) == gmp.mulmod(vals[0], vals[2], mp)
