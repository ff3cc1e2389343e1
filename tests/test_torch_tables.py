"""The port's host tables (prmers_tpu_torch/ops/fourstep.py) against the
JAX package's numpy-built FourStepTables + attach_* at n = 2^15 and 2^18,
and the convert.py round trips.

The JAX folded matrices are int8 limb planes; they are decoded back to
their u64 values mod P (limb 0 of each contraction column: sum over the
eight balanced planes of limb * 256^m) and compared with the port's u64
matrices."""

import numpy as np
import pytest

from prmers_tpu.core.field import P
from prmers_tpu.core.plan import build_plan
from prmers_tpu_torch import convert
from prmers_tpu_torch.ops import fourstep as tfs


@pytest.fixture(scope="module", params=[15, 18])
def both(request):
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    n = 1 << request.param
    plan = build_plan(int(n * 16.5) | 1, n=n)
    fp = fs.FourStepPlan.from_plan(plan)
    jt = fs.FourStepTables.build(fp, np, G=8, lanes=128)
    fs.attach_mxu_tables(jt)
    fs.attach_fused_c_tables(jt)
    kn.attach_cinrow(jt)
    kt = tfs.build_tables(tfs.FourStepPlan.from_plan(plan))
    return fp, jt, kt, kn


def _mod_p(obj):
    return np.vectorize(lambda v: int(v) % P, otypes=[object])(obj) \
        .astype(np.uint64)


def _decode_lhs(w8, L):
    """(.., 8L, 8L) LHS table -> (.., L, L) u64: rows m*L + r, limb-0
    contraction columns (in the device byte order when it is on)."""
    from prmers_tpu.ops.pallas import mxu_dft as mx
    mode = mx.lhs_bitcast_mode()
    perm = mx.lhs_byte_perm(L, mode) if mode else np.arange(8 * L)
    where = np.empty_like(perm)
    where[perm] = np.arange(8 * L)
    cols = where[np.arange(L)]
    out = np.zeros(w8.shape[:-2] + (L, L), dtype=object)
    for m in range(8):
        out = out + (w8[..., m * L:(m + 1) * L, :][..., cols]
                     .astype(np.int64).astype(object) * (256 ** m))
    return _mod_p(out)


def _decode_rhs(w8, L):
    out = np.zeros(w8.shape[:-2] + (L, L), dtype=object)
    for m in range(8):
        out = out + (w8[..., 0:L, m * L:(m + 1) * L]
                     .astype(np.int64).astype(object) * (256 ** m))
    return _mod_p(out)


def test_plan_matches(both):
    from prmers_tpu.ops.pallas import fourstep as fs
    fp, jt, kt, kn = both
    mine = kt.fp
    assert (mine.n, mine.R, mine.C) == (fp.n, fp.R, fp.C)
    assert (mine.rs.L1, mine.rs.L2) == (fp.rs.L1, fp.rs.L2)
    assert (mine.rs.freq == fp.rs.freq).all()
    assert kt.rounds == kn._carry_rounds(fp)
    assert kt.k == kn.cin_row_k(fp)
    assert tfs.carry_ct(mine) == kn.carry_ct(fp)
    assert tfs.use_r2fold(mine) == kn.use_r2fold(fp)
    assert tfs.fc_split(mine) == kn._fc_split(fp)
    assert tfs.shift_exponents(mine.rs.L1) == fs.shift_exponents(fp.rs.L1)


def test_n_sized_tables_match(both):
    fp, jt, kt, kn = both
    got = convert.tables_from_jax(jt, kt.k)
    for name in ("mf", "mi", "er", "ec", "wt", "cum", "widths"):
        mine = getattr(kt, name)
        assert got[name].shape == mine.shape, name
        assert (got[name] == mine).all(), name
    assert (convert.from_pairs(*jt.t_r).reshape(kt.fp.rs.L1, -1) ==
            tfs.FourStepTables.build(kt.fp).t_r).all()


def test_folded_matrices_match(both):
    fp, jt, kt, kn = both
    L1 = fp.rs.L1
    assert (_decode_lhs(jt.mxu["tr_fwd_w"][0], L1) == kt.k1_mats).all()
    assert (_decode_lhs(jt.mxu["iw_inv"][0], L1) == kt.k3_mats).all()
    wf8, _cf, wi8, _ci = jt.fused[:4]
    assert (_decode_rhs(wf8, 128) == kt.Mf).all()
    assert (_decode_rhs(wi8, 128) == kt.Mi).all()


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32, 64, 128])
def test_dft_matrix_matches(L):
    from prmers_tpu.ops.pallas import mxu_dft as mx
    for inverse in (False, True):
        assert (tfs.dft_matrix(L, inverse) == mx.dft_matrix(L, inverse)).all()


def test_convert_roundtrips():
    rng = np.random.default_rng(2)
    sh = (32, 1, 1024)
    x = rng.integers(0, 1 << 64, size=sh, dtype=np.uint64)
    co = rng.integers(0, 1 << 64, size=sh[:2] + (1,), dtype=np.uint64)
    (x0, x1), (c0, c1) = convert.state_to_jax(x, co)
    assert x0.dtype == np.uint32 and c0.shape == sh[:2] + (128,)
    assert (c0[..., 1:] == 0).all() and (c1[..., 1:] == 0).all()
    x2, co2 = convert.state_from_jax(x0, x1, c0, c1)
    assert (x2 == x).all() and co2.shape == co.shape and (co2 == co).all()
    u0, u1 = convert.to_pairs(x)
    assert (convert.from_pairs(u0, u1) == x).all()
    with pytest.raises(ValueError):
        convert.state_from_jax(x0, x1, np.zeros(sh[:2] + (200,)), c1)
