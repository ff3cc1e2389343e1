"""The port's unfolded r passes, K4u and K5u (ops/kernels.axis_pass on
axis 0 and 1) and the forward_r / inverse_r built on them, against the JAX
package's `_axis0_pass`, `_axis1_pass`, `_forward_r` and `_inverse_r` run
in Pallas interpret mode (PRMERS_PALLAS_INTERPRET=1) on the CPU; the
shift-twiddle form is what the JAX takes under PRMERS_NO_MXU.

Single passes at L = 16 (butterflies only), 32 and 64 (each form), with
a full and a lane-broadcast pre/post table, a scalar carry spread over
two or more widths, the wrap correction and canon. The r passes at the
plans of n = 2^15 and 2^17 (and the radix-5 n = 163840 in the matrix
form, the only one the JAX has there), with the JAX tables built as
pallas_engine._get_tables builds them without the fused attach. The
unfolded tables against the JAX's FourStepTables and decoded limb planes.
Inputs come from numpy seeds.

Tolerance: none. Outputs are compared after canon (both sides are lazy
mod P); with canon the pass output is canonical on both sides already.
"""

import os

import numpy as np
import pytest
import torch

from prmers_tpu.core.field import P as GP
from prmers_tpu.core.plan import build_plan
from prmers_tpu.utils import digits as dg
from prmers_tpu_torch import convert
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk
from test_torch_tables import _decode_lhs

_u64 = convert.from_pairs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PRMERS_NO_MXU", raising=False)
    from prmers_tpu.ops.pallas import kernels as kn
    return kn


def _canon(a64):
    a64 = np.asarray(a64, dtype=np.uint64)
    return np.where(a64 >= np.uint64(GP), a64 - np.uint64(GP), a64)


def _t(a64):
    return tgl.from_numpy_u64(a64, "cpu")


def _np(x):
    return tgl.to_numpy_u64(x)


def _jpair(a64):
    import jax.numpy as jnp
    a0, a1 = convert.to_pairs(np.asarray(a64, dtype=np.uint64))
    return jnp.asarray(a0), jnp.asarray(a1)


def _jmxu(M):
    """The JAX's (w8, corr) of a DFT with optional row scales, as
    attach_mxu_tables builds them (device byte order included)."""
    from prmers_tpu.ops.pallas import mxu_dft as mx
    L, inv, rs = M
    w8, corr = mx.build_mxu_tables(L, inv, row_scale=rs)
    mode = mx.lhs_bitcast_mode()
    if mode:
        w8 = mx.permute_lhs_cols_bytes(w8, mode)
    return w8, corr


def _tmats(M):
    L, inv, rs = M
    m = tfs.dft_matrix(L, inv)
    return _t(m if rs is None else tfs._fold_rows(m, rs))


# (axis, L, form, pre, post, cin, wcorr, canon): form "shift", "mat" (one
# matrix) or "var" (one per r2 on axis 0, per r1 on axis 1); pre/post
# None, "full" or "bcast"
CASES = {
    "a0-L16-shift-pre-post": (0, 16, "shift", "full", "bcast", False, False,
                              False),
    "a0-L16-shift-inv-canon": (0, 16, "shift", None, "full", False, False,
                               True),
    "a0-L32-shift-cin": (0, 32, "shift", "full", "bcast", True, False,
                         False),
    "a0-L32-mat-cin": (0, 32, "mat", "bcast", None, True, False, False),
    "a0-L64-var-wcorr": (0, 64, "var", None, None, False, True, False),
    "a0-L64-mat-inv-wcorr-canon": (0, 64, "mat", None, "full", False, True,
                                   True),
    "a0-L64-shift-cin-pre": (0, 64, "shift", "full", None, True, False,
                             False),
    "a1-L16-shift-post": (1, 16, "shift", None, "full", False, False,
                          False),
    "a1-L32-mat-pre-post": (1, 32, "mat", "full", "bcast", False, False,
                            False),
    "a1-L32-shift-inv-pre-post": (1, 32, "shift", "full", "bcast", False,
                                  False, False),
    "a1-L64-var-inv-pre": (1, 64, "var", "full", None, False, False, False),
    "a1-L64-shift-inv-pre-post": (1, 64, "shift", "full", "bcast", False,
                                  False, False),
}


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_axis_pass_matches_pallas(interpret, case, inverse):
    kn = interpret
    axis, L, form, pre, post, cin, wcorr, canon = CASES[case]
    R1, R2, C = (L, 8, 256) if axis == 0 else (4, L, 256)
    shape = (R1, R2, C)
    rng = np.random.default_rng(2 * list(CASES).index(case) + inverse)
    if cin:
        # digits, so that the JAX's low-word add of the parts cannot wrap
        x = rng.integers(0, 1 << 20, size=shape, dtype=np.uint64)
    else:
        x = rng.integers(0, GP, size=shape, dtype=np.uint64)

    def table(kind):
        if kind is None:
            return None, None
        sh = shape if kind == "full" else (R1, R2, 1)
        v = rng.integers(0, GP, size=sh, dtype=np.uint64)
        return _jpair(v), _t(v)

    jpre, tpre = table(pre)
    jpost, tpost = table(post)
    M = None
    if form != "shift":
        rs = None
        if form == "var":
            rs = rng.integers(0, GP, size=((R2, R1)[axis], L),
                              dtype=np.uint64)
        M = (L, inverse, rs)
    jcin = tcin = widths = None
    if cin:
        v = int(rng.integers(1 << 62, 1 << 63)) * 2 + 1
        widths = (17, 16, 17, 16) if L == 32 else (31, 30, 30)
        jcin = (np.full((1, 1), v & 0xFFFFFFFF, np.uint32),
                np.full((1, 1), v >> 32, np.uint32))
        tcin = v
    jw = tw = None
    if wcorr:
        n = 1 << 12
        er = rng.integers(0, n, size=(R1, R2), dtype=np.uint32)
        ec = rng.integers(0, n, size=(C,), dtype=np.uint32)
        jw = (er.reshape(R1, R2, 1), ec.reshape(1, C), n)
        tw = (torch.from_numpy(er.astype(np.int32)),
              torch.from_numpy(ec.astype(np.int32)), n)
    x0, x1 = _jpair(x)
    run = kn._axis0_pass if axis == 0 else kn._axis1_pass
    kw = dict(pre=jpre, post=jpost, mxu=None if M is None else _jmxu(M))
    if axis == 0:
        kw.update(cin=jcin, cin_widths=widths, wcorr=jw, canon=canon)
    r0, r1 = run(x0, x1, L, inverse, **kw)
    got = tk.axis_pass(
        _t(x), axis, inverse, pre=tpre, post=tpost,
        mats=None if M is None else _tmats(M), cin=tcin,
        cin_widths=None if widths is None else torch.tensor(
            widths, dtype=torch.int32), wcorr=tw, canon=canon)
    want = _u64(np.asarray(r0), np.asarray(r1))
    if canon:
        assert (_np(got) == want).all()
    else:
        assert (_canon(_np(got)) == _canon(want)).all()


def test_shift_butterflies_equal_the_dft_matrix():
    """The butterflies are the DIF-order DFT (and the inverse the natural
    order mirror) that tfs.dft_matrix writes out, at every L dividing 64."""
    rng = np.random.default_rng(64)
    for L in (1, 2, 4, 8, 16, 32, 64):
        x = _t(rng.integers(0, 1 << 64, size=(L, 3, 32), dtype=np.uint64))
        for inverse in (False, True):
            M = _t(tfs.dft_matrix(L, inverse))
            want = tgl.matmul_mod(M, x.permute(1, 0, 2)).permute(1, 0, 2)
            got = tk.dft_shift_plain(x, inverse)
            assert torch.equal(tgl.canon64(got), tgl.canon64(want)), (L,
                                                                      inverse)


def test_cin_parts_cover_the_carry():
    """The parts, weighted by 2^(widths before), sum back to the carry."""
    widths = [19, 18, 18, 19]
    for cin in (0, 1, (1 << 64) - 1, 0x9E3779B97F4A7C15):
        parts = tk.cin_parts(cin, widths)
        q, total = 0, 0
        for p, w in zip(parts, widths):
            total += p << q
            q += w
        assert total == cin


def test_pass_refusals():
    x = torch.zeros((8, 5, 256), dtype=torch.int64)
    with pytest.raises(ValueError, match="shift"):
        tk.axis_pass(x, 1, False)              # L = 5 divides no 64
    w = torch.tensor([32, 32], dtype=torch.int32)
    with pytest.raises(ValueError, match="axis-1"):
        tk.axis_pass(torch.zeros((4, 8, 256), dtype=torch.int64), 1, False,
                     cin=5, cin_widths=w)
    with pytest.raises(ValueError, match="widths"):
        tk.axis_pass(torch.zeros((8, 4, 256), dtype=torch.int64), 0, False,
                     cin=5)
    with pytest.raises(ValueError, match="pre"):
        tk.axis_pass(torch.zeros((8, 4, 256), dtype=torch.int64), 0, False,
                     pre=torch.zeros((8, 4, 128), dtype=torch.int64))
    # the JAX tiles the lanes of an axis-0 pass from L * S * C = 2^22 on
    # and then refuses the injection (C = 8192 at L = 64, S = 8)
    assert not tk._axis0_lane_tiled(64, 64, 4096)
    assert tk._axis0_lane_tiled(64, 64, 8192)
    with pytest.raises(ValueError, match="lane-tiled"):
        tk.axis_pass(torch.zeros((64, 8, 8192), dtype=torch.int64), 0,
                     False, cin=5, cin_widths=w)


# ---------------------------------------------------------------------------
# forward_r / inverse_r at the plans of n = 2^15, 2^17 and 163840
# ---------------------------------------------------------------------------

PLANS = {"2^15": 1 << 15, "2^17": 1 << 17, "5x2^15": 5 << 15}


@pytest.fixture(scope="module", params=list(PLANS))
def plans(request):
    """Both packages' tables at one plan: the JAX's as _get_tables builds
    them (FourStepTables.build under jit, attach_mxu_tables, no fused
    attach), the port's DevTables with the unfolded view."""
    import jax
    import jax.numpy as jnp
    from prmers_tpu.ops.pallas import fourstep as fs
    n = PLANS[request.param]
    p = 3600001 if n % 5 == 0 else int(n * 16.5) | 1
    plan = build_plan(p, n=n)
    fp = fs.FourStepPlan.from_plan(plan)
    jt = jax.jit(lambda w: fs.FourStepTables.build(
        fp, jnp, G=8, lanes=128, widths_arr=w))(fp.widths.astype(np.uint32))
    fs.attach_mxu_tables(jt, device_put=jax.device_put)
    tfp = tfs.FourStepPlan.from_plan(plan)
    u = tfs.build_unfolded(tfp)
    t = tk.with_unfolded(tk.DevTables.from_host(tfs.build_tables(tfp),
                                                "cpu"), u)
    return plan, fp, jt, u, t


def _digits(plan, rng):
    mp = (1 << plan.p) - 1
    v = int.from_bytes(rng.bytes(plan.p // 8 + 1), "little") % mp
    return dg.int_to_digits(v, plan.widths)


def test_unfolded_tables_match_jax(plans):
    plan, fp, jt, u, t = plans
    R1, R2, C = fp.rs.L1, fp.rs.L2, fp.C
    for name in ("w", "iw", "t_r", "t_r_inv", "mid", "mid_inv"):
        j = _u64(np.asarray(getattr(jt, name)[0]),
                 np.asarray(getattr(jt, name)[1]))
        assert j.shape == getattr(u, name).shape, name
        assert (j == getattr(u, name)).all(), name
    from prmers_tpu.ops.pallas import kernels as kn
    assert tuple(u.cin_widths.tolist()) == kn._cin_widths(fp)
    mx = {k: np.asarray(v[0]) for k, v in jt.mxu.items()}
    for key, L, mine in (("tr_fwd", R1, u.tr_fwd), (f"g{R1}i", R1, u.d1i),
                         (f"g{R2}f", R2, u.g2), ("tr_inv", R2, u.tri)):
        if key not in mx:
            assert mine is None, key
            continue
        assert (_decode_lhs(mx[key], L) == mine).all(), key
    assert (u.g2 is None) == (not tfs.has_matrix(R2))


def test_r_passes_match_pallas(plans, monkeypatch):
    """Each form the JAX has at the plan (the matrices, and where every
    factor divides 64 the butterflies of PRMERS_NO_MXU) against it; the two
    forms' outputs equal each other mod P."""
    plan, fp, jt, u, t = plans
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    from prmers_tpu.ops.pallas import kernels as kn
    rng = np.random.default_rng(fp.n)
    x = _digits(plan, rng).reshape(t.shape)
    z = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    cin = (1 << 63) + int(rng.integers(0, 1 << 62))
    jc = (np.full((1, 1), cin & 0xFFFFFFFF, np.uint32),
          np.full((1, 1), cin >> 32, np.uint32))
    fwd = {}
    for shift in (False, True)[:1 if fp.rs.L2 % 5 == 0 else 2]:
        if shift:
            monkeypatch.setenv("PRMERS_NO_MXU", "1")
        else:
            monkeypatch.delenv("PRMERS_NO_MXU", raising=False)
        r0, r1 = kn._forward_r(fp, jt, *_jpair(x), cin=jc)
        fwd[shift] = tgl.canon64(tk.forward_r(t, _t(x), cin=cin,
                                              shift=shift))
        assert (_np(fwd[shift]) == _canon(_u64(np.asarray(r0),
                                               np.asarray(r1)))).all()
        r0, r1 = kn._inverse_r(fp, jt, *_jpair(z))
        got = tk.inverse_r(t, _t(z), shift=shift)
        assert (_np(got) == _u64(np.asarray(r0), np.asarray(r1))).all()
    if len(fwd) == 2:
        assert torch.equal(fwd[False], fwd[True])


def test_r_passes_round_trip(plans):
    """inverse_r(forward_r(x)) is x / C: the weights, twiddles and mids
    undo, and iw's 1/n leaves 1/C where no C-transform ran (a zero
    carry)."""
    plan, fp, jt, u, t = plans
    x = _digits(plan, np.random.default_rng(7)).reshape(t.shape)
    back = tk.inverse_r(t, tk.forward_r(t, _t(x), cin=0))
    c = torch.full((1,), fp.C, dtype=torch.int64)
    assert (_np(tgl.canon64(tgl.mulmod(back, c))) == x).all()


def test_r_passes_need_the_unfolded_view(plans):
    plan, fp, jt, u, t = plans
    bare = tk.DevTables.from_host(tfs.build_tables(t.fp), "cpu")
    assert bare.unfolded is None
    with pytest.raises(ValueError, match="unfolded"):
        tk.forward_r(bare, torch.zeros(bare.shape, dtype=torch.int64))
    assert os.environ.get("PRMERS_NO_MXU") is None
