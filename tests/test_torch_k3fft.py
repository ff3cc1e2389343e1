"""K3's first launch (K3a) and both K4 launches as csrc/axis_fft.cuh's
register-pass shift butterflies, on the CPU:

  (a) the factored table k3_rs against big-int: diag(k3_rs[:, s]) @
      DFT_L1^-1 == k3_mats[s] word for word at n = 2^15, 2^17, 163840 (5 *
      2^15) and on the radix-5 (64, 10, 256) split, k3_rs = iwr / n in
      closed form, and the mesh's r2-sharded views of it;
  (b) the torch models of the CUDA bodies (kernels.p7_dft_model: the
      inverse DIT by axis_fft_model, x k3_rs, double, canon, x a;
      kernels.axis0_model: K1's body with the block-carry inject, or
      p7_dft_model with no x a) against the dense plain versions, and,
      after carry_plain, K3 against the JAX's p7_carry_pass in interpret
      mode (a = 1, a = 3 and sub2; digits and unit carries), K4 against
      _p1_pass after inject_block_carries and _p7_pass, at n = 2^15 (L1 =
      32), on a (64, 16, 256) split of 2^18 (L1 = 64) and on the radix-5
      (64, 10, 256) split.

What the wrappers hand the kernels (no k3_mats, no k1_mats) and what the
entry points launch are held in tests/test_torch_axisfft.py (e); the CUDA
kernels against their plain versions in tests/test_torch_kernels.py (gpu).

Tolerance: none. K4 forward agrees mod P (after canon); K3a and K4 inverse
give canonical words, bit for bit, and so do K3's digits and carries.
"""

import numpy as np
import pytest
import torch

from prmers_tpu_torch import convert
from prmers_tpu_torch.core.plan import build_plan
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk
from prmers_tpu_torch.utils import digits as dg

GP = (1 << 64) - (1 << 32) + 1
NS = {"2^15": 1 << 15, "2^17": 1 << 17, "5x2^15": 5 << 15}
# (n, R, C) of each JAX comparison: n = 2^15 on its own plan (32, 1, 1024),
# a (64, 16, 256) split of 2^18 and the radix-5 (64, 10, 256) split
SPLITS = {"2^15": (1 << 15, 32, 1024), "syn": (1 << 18, 1024, 256),
          "r5": (5 << 15, 640, 256)}
_u64 = convert.from_pairs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a64):
    return tgl.from_numpy_u64(a64, "cpu")


def _np(x):
    return tgl.to_numpy_u64(x)


def _canon(x):
    return _np(tgl.canon64(x))


def _port_plan(n: int, R: int, C: int) -> tfs.FourStepPlan:
    plan = build_plan(int(n * 16.5) | 1, n=n)
    return tfs.FourStepPlan(p=plan.p, n=n, R=R, C=C, rs=tfs.make_split(R),
                            cs=tfs.make_split(C), widths=plan.widths,
                            max_word=plan.max_word)


_KT = {}


def _kernel_tables(key) -> tfs.KernelTables:
    if key not in _KT:
        fp = (_port_plan(*SPLITS[key]) if key in SPLITS else
              tfs.FourStepPlan.from_plan(build_plan(int(key * 16.5) | 1,
                                                    n=key)))
        _KT[key] = tfs.build_tables(fp)
    return _KT[key]


# ---------------------------------------------------------------------------
# (a) the factored table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", list(NS) + ["r5"])
def test_k3_scales_match_bigint(size):
    """k3_mats[s] == diag(k3_rs[:, s]) @ DFT_L1^-1 word for word, and
    k3_rs[r1, r2] = 2^(-e/n) / n with e = er[r1, r2], the inverse weight's
    r-part (wr = 2^(e/n) is k1_cs)."""
    kt = _kernel_tables(NS.get(size, size))
    fp = kt.fp
    R1, R2, C = fp.shape
    n = fp.n
    assert kt.k3_rs.shape == (R1, R2) and kt.k3_rs.dtype == np.uint64
    d1i = tfs.dft_matrix(R1, True)
    for s in range(R2):
        assert (tfs.mulmod(kt.k3_rs[:, s, None], d1i) == kt.k3_mats[s]).all()
    nr2 = tfs.field.root_two_nth(n)
    inv_n = pow(n, -1, GP)
    for r1 in range(0, R1, 5):
        for r2 in range(0, R2, 3):
            e = int(kt.er[r1, r2])
            assert int(kt.k3_rs[r1, r2]) == pow(nr2, -e, GP) * inv_n % GP
            assert int(kt.k3_rs[r1, r2]) * int(kt.k1_cs[r1, r2]) % GP == inv_n


@pytest.mark.parametrize("s", [2, 4])
def test_shard_views_carry_k3_rs(s):
    """The r2-sharded view keeps its columns of k3_rs (axis 1, as k1_cs);
    on each rank's view the models of K3a and K4 equal the plain versions
    there."""
    kt = _kernel_tables(1 << 18)
    rng = np.random.default_rng(40 + s)
    R2 = kt.k3_rs.shape[1]
    m = R2 // s
    for rank in (0, s - 1):
        t = tk.DevTables.from_host(kt, "cpu", tk.R2_VIEW, rank, s)
        assert (_np(t.k3_rs) == kt.k3_rs[:, rank * m:(rank + 1) * m]).all()
        z = _t(rng.integers(0, 1 << 64, size=t.shape, dtype=np.uint64))
        for a in (1, 3):
            assert torch.equal(tk.p7_dft_model(t, z, a),
                               tk.p7_dft_plain(t, z, a)), (rank, a)
        assert torch.equal(tk.axis0_model(t, z, True),
                           tk.axis0_plain(t, z, True))
        assert (_canon(tk.axis0_model(t, z, False)) ==
                _canon(tk.axis0_plain(t, z, False))).all()


# ---------------------------------------------------------------------------
# (b) the models against the plain versions and the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(SPLITS))
def both(request):
    """The JAX and the port's tables of one split, and seeded inputs: the
    digits of a value, unit and block carries, and lazy words (any u64)
    and residues (< P, some P - 1) for the inverse."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PRMERS_PALLAS_INTERPRET", "1")
    mp.setenv("PRMERS_NO_CHAIN", "1")
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    n, R, C = SPLITS[request.param]
    fp = _port_plan(n, R, C)
    jfp = fs.FourStepPlan(p=fp.p, n=n, R=R, C=C, rs=fs.make_split(R),
                          cs=fs.make_split(C), widths=fp.widths,
                          max_word=fp.max_word)
    jt = fs.FourStepTables.build(jfp, np, G=8, lanes=128)
    fs.attach_mxu_tables(jt)
    fs.attach_fused_c_tables(jt)
    kn.attach_cinrow(jt)
    t = tk.DevTables.from_host(_kernel_tables(request.param), "cpu")
    rng = np.random.default_rng(n + R)
    v = int.from_bytes(rng.bytes(fp.p // 8 + 1), "little") % \
        ((1 << fp.p) - 1)
    x = dg.int_to_digits(v, fp.widths).reshape(t.shape)
    bco = rng.integers(0, 1 << 40, size=t.block_carry_shape, dtype=np.uint64)
    bco[-1, 0] = (1 << 46) - 1           # the last block's wrap to block 0
    lazy = rng.integers(0, 1 << 64, size=t.shape, dtype=np.uint64)
    z = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    z.reshape(-1)[::97] = GP - 1
    yield dict(kn=kn, jfp=jfp, jt=jt, t=t, x=x, bco=bco, lazy=lazy, z=z)
    mp.undo()


def _jpair(a64):
    import jax.numpy as jnp
    a0, a1 = convert.to_pairs(np.asarray(a64, dtype=np.uint64))
    return jnp.asarray(a0), jnp.asarray(a1)


@pytest.mark.parametrize("variant", ["a1", "a3", "sub2"])
def test_k3_model_matches_plain_and_pallas(both, variant):
    """p7_dft_model equals p7_dft_plain bit for bit on lazy words and on
    residues; after carry_plain (with sub2 in the LL variant) its digits
    and unit carries equal the JAX's p7_carry_pass (_p7c_kernel)."""
    import jax.numpy as jnp
    kn, t = both["kn"], both["t"]
    a = 3 if variant == "a3" else 1
    sub2 = variant == "sub2"
    assert t.shape[0] == (32 if t.fp.n == 1 << 15 else 64)
    for src in ("lazy", "z"):
        v = _t(both[src])
        assert torch.equal(tk.p7_dft_model(t, v, a),
                           tk.p7_dft_plain(t, v, a)), src
    d, co = tk.carry_plain(t, tk.p7_dft_model(t, _t(both["z"]), a), sub2)
    dw, cw = tk.p7_carry_plain(t, _t(both["z"]), a, sub2)
    assert torch.equal(d, dw) and torch.equal(co, cw)
    ap = (jnp.full((1, 1), np.uint32(a)), jnp.zeros((1, 1), jnp.uint32))
    d0, d1, c0, c1 = kn.p7_carry_pass(both["jfp"], both["jt"],
                                      *_jpair(both["z"]), ap, a == 1,
                                      sub2=sub2 or None)
    x2, co2 = convert.state_from_jax(d0, d1, c0, c1)
    assert (x2 == _np(d)).all() and (co2 == _np(co)).all()


@pytest.mark.parametrize("what", ["fwd", "fwd+carries", "inverse"])
def test_k4_model_matches_plain_and_pallas(both, what):
    """axis0_model against axis0_plain (forward mod P, inverse bit for bit)
    and against the JAX: forward without carries against _p1_pass (the
    hybrid's K4), with the (R1, 1) block carries against
    inject_block_carries then _p1_pass, inverse against _p7_pass."""
    kn, jfp, jt, t = both["kn"], both["jfp"], both["jt"], both["t"]
    if what == "inverse":
        for src in ("lazy", "z"):
            mine = tk.axis0_model(t, _t(both[src]), True)
            assert torch.equal(mine, tk.axis0_plain(t, _t(both[src]), True))
        r0, r1 = kn._p7_pass(jfp, jt, *_jpair(both["z"]), wfold=True)
        assert (_u64(r0, r1) == _np(mine)).all()
        return
    co = _t(both["bco"]) if what == "fwd+carries" else None
    x = _t(both["x"])
    mine = tk.axis0_model(t, x, False, co=co)
    assert (_canon(mine) == _canon(tk.axis0_plain(t, x, False, co=co))).all()
    j0, j1 = _jpair(both["x"])
    if co is not None:
        j0, j1 = kn.inject_block_carries(jfp, j0, j1, *_jpair(both["bco"]))
    r0, r1 = kn._p1_pass(jfp, jt, j0, j1, wfold=True)
    assert (_canon(_t(_u64(r0, r1))) == _canon(mine)).all()
