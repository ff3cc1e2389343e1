"""The port's K1-K3 (prmers_tpu_torch.ops.kernels) against the JAX
package's Pallas kernels in interpret mode, on the CPU.

At n = 2^15 (p = 540673, as tests/test_pallas_rowcarry.py) each plain
kernel takes the same numpy-seeded inputs as p1_carry_pass /
fused_c_pass(r2fold=True) / p7_carry_pass: K1 and K2 must agree mod P
(both sides are lazy), K3 exactly on digits and carry values. At n = 2^18
(L2 = 4, so the r2 DFT is not trivial) the port's pre-carry pipeline must
equal fourstep.square_ref. A CUDA twin compares each kernel with its plain
version on the card and skips on a machine without one.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from prmers_tpu.core.plan import build_plan
from prmers_tpu.utils import digits as dg
from prmers_tpu_torch import convert
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk

N = 1 << 15
P_EXP = int(N * 16.5) | 1
GP = (1 << 64) - (1 << 32) + 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side,
    and torch's thread pools in each of them would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    saved = {k: os.environ.get(k) for k in
             ("PRMERS_PALLAS_INTERPRET", "PRMERS_NO_CHAIN")}
    os.environ["PRMERS_PALLAS_INTERPRET"] = "1"
    os.environ["PRMERS_NO_CHAIN"] = "1"
    import jax.numpy as jnp
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    plan = build_plan(P_EXP, n=N)
    fp = fs.FourStepPlan.from_plan(plan)
    tbl = fs.FourStepTables.build(fp, jnp, G=8, lanes=128)
    fs.attach_mxu_tables(tbl)
    fs.attach_fused_c_tables(tbl)
    kn.attach_cinrow(tbl)
    assert kn.use_rowcarry(fp, tbl) and kn.use_r2fold(fp)
    yield plan, fp, tbl, kn
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def port():
    plan = build_plan(P_EXP, n=N)
    fp = tfs.FourStepPlan.from_plan(plan)
    return plan, tk.DevTables.from_host(tfs.build_tables(fp), "cpu")


def _digits(plan, rng):
    mp = (1 << plan.p) - 1
    v = int.from_bytes(rng.bytes(plan.p // 8 + 1), "little") % mp
    return dg.int_to_digits(v, plan.widths)


def _pairs(a64, shape):
    return convert.to_pairs(np.asarray(a64, dtype=np.uint64).reshape(shape))


_u64 = convert.from_pairs


def _canon(a64):
    a64 = np.asarray(a64, dtype=np.uint64)
    return np.where(a64 >= np.uint64(GP), a64 - np.uint64(GP), a64)


def _t(a64):
    return tgl.from_numpy_u64(a64, "cpu")


def _np(x):
    return tgl.to_numpy_u64(x)


@pytest.fixture(scope="module")
def stages(jax_side, port):
    """One set of inputs threaded through both pipelines stage by stage."""
    plan, t = port
    _plan, fp, tbl, kn = jax_side
    import jax.numpy as jnp
    sh = t.shape
    rng = np.random.default_rng(11)
    x = _digits(plan, rng).reshape(sh)
    co = rng.integers(0, 1 << 40, size=t.carry_shape, dtype=np.uint64)
    co[0, 0] = (1 << 45) + 12345          # a wide carry in the last-row wrap
    co[-1, -1] = (1 << 46) - 1
    return dict(x=x, co=co, sh=sh, jnp=jnp)


def test_k1_matches_pallas(jax_side, port, stages):
    _plan, fp, tbl, kn = jax_side
    plan, t = port
    jnp, sh = stages["jnp"], stages["sh"]
    x, co = stages["x"], stages["co"]
    rolled = np.roll(co.reshape(-1), 1).reshape(co.shape)
    (x0, x1), (c0, c1) = convert.state_to_jax(x, rolled)
    r0, r1 = kn.p1_carry_pass(fp, tbl, jnp.asarray(x0), jnp.asarray(x1),
                              jnp.asarray(c0), jnp.asarray(c1))
    mine = tk.p1_carry_pass(t, _t(x), _t(co))
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()
    stages["k1"] = _canon(_np(mine))


@pytest.mark.parametrize("mode", ["sqr", "fwd", "mul"])
def test_k2_matches_pallas(jax_side, port, stages, mode):
    _plan, fp, tbl, kn = jax_side
    plan, t = port
    jnp, sh = stages["jnp"], stages["sh"]
    if "k1" not in stages:
        stages["k1"] = _canon(_np(tk.p1_carry_pass(
            t, _t(stages["x"]), _t(stages["co"]))))
    s = stages["k1"]
    u = None
    if mode == "mul":
        rng = np.random.default_rng(23)
        u = rng.integers(0, GP, size=sh, dtype=np.uint64)
    s0, s1 = _pairs(s, sh)
    ju = None if u is None else tuple(jnp.asarray(a) for a in _pairs(u, sh))
    r0, r1 = kn.fused_c_pass(fp, tbl, jnp.asarray(s0), jnp.asarray(s1),
                             mode, u=ju, r2fold=True)
    mine = tk.fused_c_pass(t, _t(s), mode, u=None if u is None else _t(u))
    assert (_canon(_u64(r0, r1)) == _canon(_np(mine))).all()
    if mode == "sqr":
        stages["k2"] = _canon(_np(mine))


@pytest.mark.parametrize("variant", ["a1", "a3", "sub2"])
def test_k3_matches_pallas(jax_side, port, stages, variant):
    _plan, fp, tbl, kn = jax_side
    plan, t = port
    jnp, sh = stages["jnp"], stages["sh"]
    if "k2" not in stages:
        s = tk.p1_carry_pass(t, _t(stages["x"]), _t(stages["co"]))
        stages["k2"] = _canon(_np(tk.fused_c_pass(t, s, "sqr")))
    z = stages["k2"]
    z0, z1 = _pairs(z, sh)
    a = 3 if variant == "a3" else 1
    ap = (jnp.full((1, 1), np.uint32(a)), jnp.zeros((1, 1), jnp.uint32))
    d0, d1, co0, co1 = kn.p7_carry_pass(
        fp, tbl, jnp.asarray(z0), jnp.asarray(z1), ap, a == 1,
        sub2=(variant == "sub2") or None)
    d, co = tk.p7_carry_pass(t, _t(z), a=a, sub2=(variant == "sub2"))
    assert (_u64(d0, d1) == _np(d)).all()
    assert (_u64(co0, co1)[..., ::128] == _np(co)).all()
    assert (np.asarray(co0)[..., 1:] == 0).all()


def test_precarry_pipeline_matches_square_ref():
    """n = 2^18: K1 (no carry) -> K2 sqr -> K3's DFT half equals the numpy
    oracle of the whole pre-carry squaring."""
    from prmers_tpu.ops.pallas import fourstep as fs
    n = 1 << 18
    p = int(n * 16.5) | 1
    plan = build_plan(p, n=n)
    fpj = fs.FourStepPlan.from_plan(plan)
    tj = fs.FourStepTables.build(fpj, np, G=1, lanes=128)
    fp = tfs.FourStepPlan.from_plan(plan)
    assert (fp.rs.L1, fp.rs.L2, fp.C) == (64, 4, 1024)
    t = tk.DevTables.from_host(tfs.build_tables(fp), "cpu")
    rng = np.random.default_rng(3)
    x = _digits(plan, rng)
    want = fs.square_ref(tj, x)
    xt = _t(x.reshape(t.shape))
    zero = torch.zeros(t.carry_shape, dtype=torch.int64)
    s = tk.p1_carry_plain(t, xt, zero)
    s = tk.fused_c_plain(t, s, "sqr")
    got = _np(tk.p7_dft_plain(t, s)).reshape(-1)
    assert (got == want).all()


def test_square_step_value(port):
    """Two chained steps with a = 3 and the pending row carries equal
    big-int x^2 * 3 mod M_p."""
    plan, t = port
    mp = (1 << plan.p) - 1
    rng = np.random.default_rng(5)
    x = _digits(plan, rng)
    v = dg.digits_to_int(x, plan.widths)
    xt = _t(x.reshape(t.shape))
    co = torch.zeros(t.carry_shape, dtype=torch.int64)
    for _ in range(2):
        xt, co = tk.square_step(t, xt, co, a=3)
        v = v * v * 3 % mp
    q = dg.bit_positions(plan.widths)
    R, C = t.shape[0] * t.shape[1], t.shape[2]
    cov = _np(co).reshape(-1)
    pend = sum(int(cov[b]) << (0 if b == R - 1 else int(q[(b + 1) * C]))
               for b in range(R))
    got = (dg.digits_to_int(_np(xt).reshape(-1), plan.widths) + pend) % mp
    assert got == v


def test_wrappers_refuse_bad_operands(port):
    """The kernels index their operands from the tables' shape, so a wrong
    shape, dtype or layout raises before any pointer is handed over."""
    plan, t = port
    x = torch.zeros(t.shape, dtype=torch.int64)
    co = torch.zeros(t.carry_shape, dtype=torch.int64)
    strided = torch.zeros(t.shape[:2] + (2 * t.shape[2],),
                          dtype=torch.int64)[..., ::2]
    bad = [(x[:, :, :-128], co), (x.to(torch.int32), co), (strided, co),
           (x, co[:-1])]
    for bx, bco in bad:
        with pytest.raises(ValueError):
            tk.p1_carry_pass(t, bx, bco)
    with pytest.raises(ValueError):
        tk.fused_c_pass(t, x, "mul", u=x[:-1])
    with pytest.raises(ValueError):
        tk.p7_carry_pass(t, x, co_out=co.reshape(-1))


GPU_CASES = {str(logn): (1 << logn, tfs.Pipeline())
             for logn in range(15, 27)}
GPU_CASES.update({
    "16-t4": (1 << 16, tfs.Pipeline(carry_max=16384)),
    "18-split-t2": (1 << 18, tfs.Pipeline(r2fold_max=2048,
                                          carry_max=1 << 17, fc_split=True)),
    "18-k6": (1 << 18, tfs.Pipeline(r2fold_max=2048)),
})
# the radix-5 plans, every L2 = 5 * 2^b the port plans: 5 (5 * 2^16), 10,
# 20, 40, 80, 160 and 320 (K5 at 5 * 2^23), all in the split form
GPU_CASES.update({f"5x2^{logn}": (5 << logn, tfs.Pipeline())
                  for logn in (16, 17, 18, 19, 20, 21, 22, 23)})


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_cuda_kernels_match_plain(case):
    """On the card: every kernel wrapper against its plain version at each
    n = 2^logn the engine takes, 2^15 ... 2^26 (R2 = 1 ... 128, C = 1024
    ... 8192, so every rows-per-block branch of the row kernel and every
    carry unit of K3b), at the forced big-shape pipelines (T = 4 and T = 2
    carry units at small n), and at the radix-5 n = 5 * 2^16 ... 5 * 2^23
    (L2 = 5, 10, 20, 40, 80, 160, 320, and 320 at C = 2048; K2's r2
    launches and K5 in the split form). K3 takes the C-transform's lazy
    output, as on the main path; K6b takes K6 "fwd"'s. K4 runs forward
    with and without block carries and inverse on that lazy output; K7
    takes K4 inverse's output with a = 1 and a = 3. Where fourstep.chain_ok holds
    (n = 2^15 ... 2^19), K9 runs a = [3, 1, 3] and then a chain of 2 on its
    carries, bit for bit against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, pipe = GPU_CASES[case]
    plan = build_plan(int(n * 16.5) | 1, n=n)
    t = tk.DevTables.from_host(
        tfs.build_tables(tfs.FourStepPlan.from_plan(plan, pipe)), "cuda")
    rng = np.random.default_rng(n)
    x = _t(_digits(plan, rng).reshape(t.shape)).cuda()
    co = torch.from_numpy(rng.integers(0, 1 << 40, size=t.carry_shape,
                                       dtype=np.int64)).cuda()

    def same(got, want):
        return torch.equal(tgl.canon64(got), tgl.canon64(want))

    s = tk.p1_carry_pass(t, x, co)
    assert same(s, tk.p1_carry_plain(t, x, co))
    for which in ("p2", "p6"):
        assert same(tk.axis1_pass(t, s, which), tk.axis1_plain(t, s, which))
    for r2fold in (True, False):
        for mode in ("sqr", "fwd", "mul"):
            u = s if mode == "mul" else None
            got = tk.fused_c_pass(t, s, mode, u=u, r2fold=r2fold)
            want = tk.fused_c_plain(t, s, mode, u, r2fold)
            assert same(got, want), (r2fold, mode)
            if mode == "fwd" and not r2fold:
                v = got
    for op in ("sqr", "mul", ""):
        u = s if op == "mul" else None
        assert same(tk.fused_c_invh_pass(t, v, op, u=u),
                    tk.fused_c_invh_plain(t, v, op, u)), op
    z = tk.fused_mid(t, s.clone(), "sqr")
    for a, sub2 in ((1, False), (3, False), (1, True)):
        d, c = tk.p7_carry_pass(t, z, a=a, sub2=sub2)
        dw, cw = tk.p7_carry_plain(t, z, a, sub2)
        assert torch.equal(d, dw) and torch.equal(c, cw), (a, sub2)
    # K4 forward without and with (R1, 1) block carries, K4 inverse, K7
    bco = torch.from_numpy(rng.integers(0, 1 << 45, size=t.block_carry_shape,
                                        dtype=np.int64)).cuda()
    for c in (None, bco):
        assert same(tk.axis0_pass(t, x, False, co=c),
                    tk.axis0_plain(t, x, False, co=c))
    y = tk.axis0_pass(t, z, True)
    assert torch.equal(y, tk.axis0_plain(t, z, True))
    for a in (1, 3):
        d, c = tk.block_carry_pass(t, y, a)
        dw, cw = tk.block_carry_plain(t, y, a)
        assert torch.equal(d, dw) and torch.equal(c, cw), a
    if tfs.chain_ok(t.fp):              # K9: n = 2^15 ... 2^19
        for a in ([3, 1, 3], [1, 3]):
            d, c = tk.square_chain(t, x, co, a)
            dw, cw = tk.square_chain_plain(t, x, co, a, len(a))
            assert torch.equal(d, dw) and torch.equal(c, cw), a
            x, co = d, c


@pytest.mark.gpu
@pytest.mark.parametrize("logn", [15, 16, 17, 18, 19])
def test_cuda_k9_row_forms_match_plain(logn):
    """On the card: at each (L1, L2) K9 takes, the kernel with its row
    phase forced to each form (kernels.square_chain_part "fused": the row
    kernel's group; "split": the lane, slot and inverse lane phases),
    a = [3, 1, 3] and then [1, 3] on its output, digits and unit carries
    bit for bit against the plain chain, whichever form the shape's rule
    picks for the engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 1 << logn
    plan = build_plan(int(n * 16.5) | 1, n=n)
    t = tk.DevTables.from_host(
        tfs.build_tables(tfs.FourStepPlan.from_plan(plan)), "cuda")
    rng = np.random.default_rng(700 + logn)
    x0 = _t(_digits(plan, rng).reshape(t.shape)).cuda()
    co0 = torch.from_numpy(rng.integers(0, 1 << 40, size=t.carry_shape,
                                        dtype=np.int64)).cuda()
    for form in ("fused", "split"):
        x, co = x0.clone(), co0.clone()
        for a in ([3, 1, 3], [1, 3]):
            dw, cw = tk.square_chain_plain(t, x, co, a, len(a))
            tk.square_chain_part(t, x, co, tk.chain_multipliers(a, "cuda"),
                                 len(a), form=form)
            assert torch.equal(x, dw) and torch.equal(co, cw), (form, a)


@pytest.mark.gpu
@pytest.mark.parametrize("logn", [15, 16, 17, 18, 19])
def test_cuda_k9_long_chain_matches_steps(logn):
    """On the card: at each (L1, L2) K9 takes ((32, 1), (64, 1), (64, 2),
    (64, 4), (64, 8)), a chain of 600 squarings x^2 * a_k (a_k in {1, 3},
    numpy-seeded) through FourStepEngine.square_mul_seq, which splits it
    into K9 launches of CHAIN_K = 512 and 88, against an engine on
    Pipeline(chain=False) that runs 600 three-kernel steps: digits and
    unit carries bit for bit, and the value equal."""
    from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 1 << logn
    p = int(n * 16.5) | 1
    plan = build_plan(p, n=n)
    chain = FourStepEngine(p, 1, plan=plan, device="cuda")
    steps = FourStepEngine(p, 1, plan=plan, device="cuda",
                           pipe=tfs.Pipeline(chain=False))
    assert chain._chain and not steps._chain
    rng = np.random.default_rng(600 + logn)
    v = int.from_bytes(rng.bytes(p // 8 + 1), "little") % ((1 << p) - 1)
    a = [int(k) for k in rng.choice([1, 3], size=600)]
    before = tk.calls["k9_chain"]
    for e in (chain, steps):
        e.set(0, v)
        e.square_mul_seq(0, a)
    assert tk.calls["k9_chain"] - before == 2
    for got, want in zip(chain.regs[0][:2], steps.regs[0][:2]):
        assert torch.equal(got, want)
    assert chain.get_int(0) == steps.get_int(0)


@pytest.mark.gpu
@pytest.mark.parametrize("ca", [2, 4, 8, 16, 32, 64])
def test_cuda_row_kernel_matches_plain(ca):
    """On the card: the factored row kernel (csrc/fused_c_row.cuh) as K6
    in modes sqr / mul / fwd and as K6b with head ops sqr / mul / none,
    against the dense plain versions, on lazy words at C = 128 * ca, with
    R = 64 rows (one per block) and R = 2048 (up to four per block: every
    rows-per-block branch), in place and out of place."""
    import types
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    C = 128 * ca
    dev = torch.device("cuda", 0)
    for R in (64, 2048):
        n = R * C
        fp = tfs.FourStepPlan(p=int(n * 16.5) | 1, n=n, R=R, C=C, rs=None,
                              cs=None, widths=None, max_word=0)
        Mf, Mi, _wf, _wi = tfs.fused_c_mats(fp)
        cs_f, cs_i = tfs.fused_c_scales(fp)
        t = types.SimpleNamespace(
            fp=fp, shape=(1, R, C), device=dev, row_carry_shape=(1, R, 1),
            **{k: tgl.from_numpy_u64(v, dev) for k, v in (
                ("Mf", Mf), ("Mi", Mi), ("cs_f", cs_f), ("cs_i", cs_i),
                ("lane_f", tfs.dft_matrix(ca, False)),
                ("lane_i", tfs.dft_matrix(ca, True)))})
        rng = np.random.default_rng(ca * R)
        x, u = (tgl.from_numpy_u64(rng.integers(
            0, 1 << 64, size=t.shape, dtype=np.uint64), dev)
            for _ in range(2))

        def same(got, want):
            return torch.equal(tgl.canon64(got), tgl.canon64(want))

        for mode in ("sqr", "mul", "fwd"):
            um = u if mode == "mul" else None
            want = tk.fused_c_plain(t, x, mode, um, r2fold=False)
            assert same(tk.fused_c_pass(t, x, mode, u=um, r2fold=False),
                        want), (R, mode)
            y = x.clone()
            tk.fused_c_pass(t, y, mode, u=um, out=y, r2fold=False)
            assert same(y, want), (R, mode, "in place")
        for op in ("sqr", "mul", ""):
            um = u if op == "mul" else None
            want = tk.fused_c_invh_plain(t, x, op, um)
            assert same(tk.fused_c_invh_pass(t, x, op, u=um), want), (R, op)
            y = x.clone()
            tk.fused_c_invh_pass(t, y, op, u=um, out=y)
            assert same(y, want), (R, op, "in place")


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32, 64, 128])
def test_cuda_axis_fft_matches_plain(L):
    """On the card: csrc/axis_fft.cuh's shift butterflies at every length
    L against the dense plain versions, on lazy words: K5's P2 and P6 on a
    (3, L, 512) register with seeded mf, mi and row scales t_r_inv (tri =
    diag(t_r_inv[r1]) DFT^-1), out of place and in place; at L = 32 and 64
    K1 on the plans that have that L1 (n = 2^15, 2^18), in place; at L =
    64 and 128 the move-only body launches (it computes no transform)."""
    import types
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    R1, C = 3, 512
    rng = np.random.default_rng(1000 + L)
    trs = rng.integers(0, GP, size=(R1, L), dtype=np.uint64)

    def put(a):
        return tgl.from_numpy_u64(a, dev)

    t = types.SimpleNamespace(
        shape=(R1, L, C), device=dev, row_carry_shape=(R1, L, 1),
        g2=put(tfs.dft_matrix(L, False)),
        tri=put(tfs._fold_rows(tfs.dft_matrix(L, True), trs)),
        t_r_inv=put(trs), dft5_f=None,
        **{k: put(rng.integers(0, GP, size=(R1, L, C), dtype=np.uint64))
           for k in ("mf", "mi")})
    x = put(rng.integers(0, 1 << 64, size=t.shape, dtype=np.uint64))

    def same(got, want):
        return torch.equal(tgl.canon64(got), tgl.canon64(want))

    for which in ("p2", "p6"):
        want = tk.axis1_plain(t, x, which)
        assert same(tk.axis1_pass(t, x, which), want), which
        y = x.clone()
        tk.axis1_pass(t, y, which, out=y)
        assert same(y, want), (which, "in place")
        if L >= 64:
            tk.axis_fft_move(t, x, which)
    if L in (32, 64):
        n = 1 << (15 if L == 32 else 18)
        plan = build_plan(int(n * 16.5) | 1, n=n)
        tt = tk.DevTables.from_host(
            tfs.build_tables(tfs.FourStepPlan.from_plan(plan)), dev)
        assert tt.shape[0] == L
        xd = _t(_digits(plan, rng).reshape(tt.shape)).to(dev)
        co = torch.from_numpy(rng.integers(0, 1 << 40, size=tt.carry_shape,
                                           dtype=np.int64)).to(dev)
        want = tk.p1_carry_plain(tt, xd, co)
        tk.p1_carry_pass(tt, xd, co, out=xd)
        assert same(xd, want)
        if L == 64:
            tk.axis_fft_move(tt, xd, "k1")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("logn", [15, 18])
def test_cuda_k3_k4_shift_match_plain(logn):
    """On the card: K3 (one launch: the r1 inverse as csrc/axis_fft.cuh's
    shift butterflies, then the row carry by tiles with edge words, csrc/
    k3_p7c.cu) at L1 = 32 (n = 2^15) and 64 (2^18) with a = 1, a = 3 and
    sub2, in place on lazy words, each twice (the scratch's second launch
    and on), digits and carries bit for bit against the plain version, one
    wrapper call a launch; K4 forward without and with (R1, 1) block
    carries (mod P) and K4 inverse (bit for bit), in place; at L1 = 64 the
    move-only bodies of K3a and K4 forward launch (they compute no
    transform)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    n = 1 << logn
    plan = build_plan(int(n * 16.5) | 1, n=n)
    t = tk.DevTables.from_host(
        tfs.build_tables(tfs.FourStepPlan.from_plan(plan)), dev)
    assert t.shape[0] == (32 if logn == 15 else 64)
    rng = np.random.default_rng(2000 + logn)
    z = _t(rng.integers(0, 1 << 64, size=t.shape, dtype=np.uint64)).to(dev)
    x = _t(_digits(plan, rng).reshape(t.shape)).to(dev)
    bco = torch.from_numpy(rng.integers(0, 1 << 45, size=t.block_carry_shape,
                                        dtype=np.int64)).to(dev)
    for a, sub2 in ((1, False), (3, False), (1, True)):
        dw, cw = tk.p7_carry_plain(t, z, a, sub2)
        for _ in range(2):
            y = z.clone()
            before = tk.calls["k3_p7c"]
            d, c = tk.p7_carry_pass(t, y, a=a, sub2=sub2, out=y)
            assert tk.calls["k3_p7c"] == before + 1
            assert d is y and torch.equal(d, dw) and torch.equal(c, cw), \
                (a, sub2)
    for c in (None, bco):
        want = tk.axis0_plain(t, x, False, co=c)
        y = x.clone()
        tk.axis0_pass(t, y, False, co=c, out=y)
        assert torch.equal(tgl.canon64(y), tgl.canon64(want)), c is None
    want = tk.axis0_plain(t, z, True)
    y = z.clone()
    tk.axis0_pass(t, y, True, out=y)
    assert torch.equal(y, want)
    if logn == 18:
        for which in ("k3", "k4f"):
            tk.axis_fft_move(t, z, which)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [1, 2, 4, 5, 6])
def test_cuda_k3_any_rounds_match_plain(rounds):
    """On the card: K3 at n = 2^18 (L1 = 64) and 2^15 (L1 = 32) with the
    round count forced (the plans' own is 2 to 4: unrolled at 2, 3, 4, a
    loop elsewhere) on tables with a scratch of that count, in place, a =
    1, 3 and sub2, digits and carries bit for bit against the plain
    version; the plan's own scratch, too small for more rounds, refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for logn in (18, 15):
        n = 1 << logn
        plan = build_plan(int(n * 16.5) | 1, n=n)
        t0 = tk.DevTables.from_host(
            tfs.build_tables(tfs.FourStepPlan.from_plan(plan)), "cuda")
        t = dataclasses.replace(t0, rounds=rounds, k3_scratch=torch.zeros(
            tk.k3_scratch_words(t0.shape, rounds), dtype=torch.int64,
            device="cuda"))
        rng = np.random.default_rng(400 + rounds + logn)
        z = _t(rng.integers(0, 1 << 64, size=t.shape,
                            dtype=np.uint64)).cuda()
        for a, sub2 in ((1, False), (3, False), (1, True)):
            dw, cw = tk.p7_carry_plain(t, z, a, sub2)
            y = z.clone()
            d, c = tk.p7_carry_pass(t, y, a=a, sub2=sub2, out=y)
            assert torch.equal(d, dw) and torch.equal(c, cw), (logn, a, sub2)
        if rounds > t0.rounds:
            with pytest.raises(RuntimeError, match="k3_p7c"):
                tk.p7_carry_pass(dataclasses.replace(t0, rounds=rounds), z)


@pytest.mark.gpu
@pytest.mark.parametrize("logn", [23, 25])
def test_cuda_k3_repeat_launches_equal(logn):
    """On the card: K3 launched 200 times on one input at n = 2^23 (T = 1)
    and 2^25 (T = 2), every launch's digits and unit carries bit for bit
    against the plain version: a fault in the order between its tiles (an
    edge word read before it is written) shows now and then, not every
    time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 1 << logn
    plan = build_plan(int(n * 16.5) | 1, n=n)
    t = tk.DevTables.from_host(
        tfs.build_tables(tfs.FourStepPlan.from_plan(plan)), "cuda")
    assert t.row_carry_shape[2] == (1 if logn == 23 else 2)
    rng = np.random.default_rng(300 + logn)
    z = _t(rng.integers(0, 1 << 64, size=t.shape, dtype=np.uint64)).cuda()
    dw, cw = tk.p7_carry_plain(t, z)
    out = torch.empty_like(z)
    co = torch.empty(t.row_carry_shape, dtype=torch.int64, device="cuda")
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(200):
        tk.p7_carry_pass(t, z, out=out, co_out=co)
        bad += (out != dw).sum() + (co != cw).sum()
    assert int(bad) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("logn,s", [(18, 2), (18, 4), (23, 2), (23, 4),
                                    (26, 2), ("5x2^17", 2), ("5x2^18", 4),
                                    ("5x2^22", 2), ("5x2^22", 4)])
def test_cuda_shard_kernels_match_plain(logn, s):
    """On the card: the mesh's shard-local launches of the first and the
    last of s ranks, each against its plain version on the same inputs:
    K1, K3 (a = 1, 3 and sub2 with the rank's amount; in place, one
    launch) and K4 both ways on
    the r2-sharded view (R1, R2/s, C); K5, K6, K6b and K8 (a = 1, 3) on
    the r1-sharded view (R1/s, R2, C) (at n = 2^26 K5 at L2 = 128; at the
    radix-5 n = 5 * 2^k, L2 = 10, 20 and 320, K5 in the split form on the
    view's whole split tables)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 1 << logn if isinstance(logn, int) else \
        5 << int(logn.split("^")[1])
    plan = build_plan(int(n * 16.5) | 1, n=n)
    kt = tfs.build_tables(tfs.FourStepPlan.from_plan(plan))
    rng = np.random.default_rng(n.bit_length() + s)

    def same(got, want):
        return torch.equal(tgl.canon64(got), tgl.canon64(want))

    for rank in (0, s - 1):
        t2, t1 = (tk.DevTables.from_host(kt, "cuda", view, rank, s)
                  for view in (tk.R2_VIEW, tk.R1_VIEW))
        x = _digits(plan, rng).reshape(kt.widths.shape)
        m = x.shape[1] // s
        x2 = _t(np.ascontiguousarray(x[:, rank * m:(rank + 1) * m])).cuda()
        co = torch.from_numpy(rng.integers(0, 1 << 40,
                                           size=t2.row_carry_shape,
                                           dtype=np.int64)).cuda()
        s2 = tk.p1_carry_pass(t2, x2, co)
        assert same(s2, tk.p1_carry_plain(t2, x2, co))
        for inverse, v in ((False, x2), (True, s2)):
            got = tk.axis0_pass(t2, v, inverse)
            want = tk.axis0_plain(t2, v, inverse)
            assert torch.equal(got, want) if inverse else same(got, want)
        for a, sub2 in ((1, False), (3, False), (1, True)):
            amt = 2 if rank == 0 else 0
            y = s2.clone()              # in place, as the mesh step runs it
            d, c = tk.p7_carry_pass(t2, y, a=a, sub2=sub2, s2=amt, out=y)
            dw, cw = tk.p7_carry_plain(t2, s2, a, sub2, amt)
            assert d is y and torch.equal(d, dw) and torch.equal(c, cw), \
                (a, sub2)
        y = _t(rng.integers(0, GP, size=t1.shape, dtype=np.uint64)).cuda()
        for which in ("p2", "p6"):
            assert same(tk.axis1_pass(t1, y, which),
                        tk.axis1_plain(t1, y, which))
        for mode in ("sqr", "fwd", "mul"):
            u = y if mode == "mul" else None
            assert same(tk.fused_c_pass(t1, y, mode, u=u, r2fold=False),
                        tk.fused_c_plain(t1, y, mode, u, r2fold=False))
        for op in ("sqr", ""):
            assert same(tk.fused_c_invh_pass(t1, y, op),
                        tk.fused_c_invh_plain(t1, y, op))
        z = tgl.canon64(y)
        for a in (1, 3):
            d, c = tk.block_carry_local(t1, z, a)
            dw, cw = tk.block_carry_plain(t1, z, a, t1.k8_rounds)
            assert torch.equal(d, dw) and torch.equal(c, cw), a


# the unfolded passes' plans: n -> p (the radix-5 ones: L2 = 5, the
# smallest radix-5 factor, and L2 = 320, the largest, a 2560-byte
# contraction)
UNFOLDED_PLANS = {"2^15": (1 << 15, None), "2^17": (1 << 17, None),
                  "2^23": (1 << 23, 136279841), "5x2^15": (5 << 15, None),
                  "5x2^22": (5 << 22, 332192831)}


@pytest.mark.gpu
@pytest.mark.parametrize("plan_id", list(UNFOLDED_PLANS))
def test_cuda_unfolded_passes_match_plain(plan_id):
    """On the card: K4u and K5u, each of the four passes of forward_r (with
    a nonzero scalar carry) and inverse_r in the matrix form (the int8
    tables on the tensor cores) and, where both factors divide 64, the
    shift form, against its plain version on the same inputs, exact mod
    P; then the two r passes whole against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, p = UNFOLDED_PLANS[plan_id]
    plan = build_plan(p or int(n * 16.5) | 1, n=n)
    fp = tfs.FourStepPlan.from_plan(plan)
    t = tk.with_unfolded(tk.DevTables.from_host(tfs.build_tables(fp),
                                                "cuda"))
    rng = np.random.default_rng(n)
    x = _t(_digits(plan, rng).reshape(t.shape)).cuda()
    z = _t(rng.integers(0, GP, size=t.shape, dtype=np.uint64)).cuda()
    cin = 0x9E3779B97F4A7C15

    def same(got, want):
        return torch.equal(tgl.canon64(got), tgl.canon64(want))

    R1, R2, _C = t.shape
    for shift in (False, True)[:2 if 64 % R1 == 0 and 64 % R2 == 0 else 1]:
        ps = tk.r_passes(t, shift, cin)
        for name, v in (("k4u_fwd", x), ("k5u_fwd", x), ("k5u_inv", z),
                        ("k4u_inv", z)):
            axis, inverse, kw = ps[name]
            got = tk.axis_pass(v, axis, inverse, **kw)
            assert same(got, tk.axis_pass_plain(v, axis, inverse, **kw)), \
                (name, shift)
        assert same(tk.forward_r(t, x, cin, shift),
                    tk.forward_r_plain(t, x, cin, shift)), shift
        assert torch.equal(tk.inverse_r(t, z, shift),
                           tk.inverse_r_plain(t, z, shift)), shift


@pytest.mark.gpu
def test_cuda_probes_match_plain():
    """On the card: every probe kernel against its plain version on the
    same inputs at the TPU tools' shapes (the rep loops with fewer reps):
    probe_vpu and probe_mulmod (512, 1024), probe_fields (256, 1024) per
    op after canon, probe_bitcast and every probe_shapes case bit for
    bit, each both into a tensor the wrapper allocates and into a
    preallocated out= (as the tools time them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from prmers_tpu_torch.ops import probes as pr

    def both(call, want, norm=lambda v: v):
        out = torch.full_like(want, -7)
        assert call(out).data_ptr() == out.data_ptr()
        return (torch.equal(norm(call(None)), norm(want)) and
                torch.equal(norm(out), norm(want)))

    x = pr.rep_inputs("vpu", (512, 1024), device="cuda")[0].contiguous()
    assert both(lambda o: pr.vpu(x, 16, out=o),
                pr.reps_plain("vpu", x.unsqueeze(0), 16)[0])
    ab = pr.rep_inputs("gl_mul", (512, 1024), device="cuda")
    assert both(lambda o: pr.mulmod(ab, 8, out=o),
                pr.reps_plain("gl_mul", ab, 8)[:2],
                lambda v: pr.canon_planes("gl_mul", v))
    for op in pr.FIELD_OPS:
        v = pr.rep_inputs(op, (256, 1024), device="cuda")
        assert both(lambda o: pr.fields(op, v, 8, out=o),
                    pr.reps_plain(op, v, 8),
                    lambda t: pr.canon_planes(op, t)), op
    w = torch.from_numpy(pr.bitcast_pattern().view(np.int32)).cuda()
    assert both(lambda o: pr.bitcast(w, out=o), pr.bitcast_plain(w))
    for case in pr.SHAPE_CASES:
        xs = pr.shape_inputs(case, device="cuda")
        assert both(lambda o: pr.shape_case(case, *xs, out=o),
                    pr.shape_plain(case, *xs)), case
    # the int8 product off its 128 x 128 x 128 tile grid: ragged M, N and
    # K (multiples of 16), a single row, a fold over 64-row slices, and
    # extreme bytes (every product -128 * -128)
    rng = np.random.default_rng(8)
    for M, N, K, fold in ((1, 16, 16, 0), (40, 48, 80, 0),
                          (200, 272, 336, 0), (576, 1040, 528, 0),
                          (130, 128, 2560, 0), (192, 144, 96, 64),
                          (576, 1024, 512, 64)):
        w = torch.from_numpy(rng.integers(-128, 128, size=(M, K),
                                          dtype=np.int8)).cuda()
        x = torch.from_numpy(rng.integers(-128, 128, size=(K, N),
                                          dtype=np.int8)).cuda()
        assert torch.equal(pr.dot8(w, x, fold), pr.dot8_plain(w, x, fold)), \
            (M, N, K, fold)
    w = torch.full((64, 4096), -128, dtype=torch.int8, device="cuda")
    assert torch.equal(pr.dot8(w, w.t().contiguous()),
                       torch.full((64, 64), 4096 * 128 * 128,
                                  dtype=torch.int32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [127, 9941])
def test_cuda_anysize_modes_graphs_match_eager(p, tmp_path, monkeypatch):
    """On the card: a P-1 V-trace stage 2 and an Edwards ECM curve (stage
    1 and 2) on the any-size engine with every op in CUDA graphs and
    eager, and on the numpy oracle (exact integer digits): every register
    of every engine the modes made equal at the end, and the same
    result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from prmers_tpu_torch.engine.np_engine import NumpyEngine
    from prmers_tpu_torch.engine.torch_engine import TorchEngine
    from prmers_tpu_torch.io.options import Options
    from prmers_tpu_torch.modes import ecm_edwards, pm1
    mp = (1 << p) - 1
    x1 = pow(3, 2 * p * 720720, mp)
    runs = []
    for graphs in (True, False, None):
        made = []

        def create(q, regs, device=None, graphs=graphs, **kw):
            made.append(NumpyEngine(q, regs) if graphs is None else
                        TorchEngine(q, regs, device="cuda", graphs=graphs))
            return made[-1]
        for mod in (pm1, ecm_edwards):
            monkeypatch.setattr(mod, "create_engine", create)
        d = str(tmp_path / str(graphs))
        r = pm1.run_pm1_stage2_vtrace(
            Options(exponent=p, mode="pm1", b1=100, b2=3000, save_dir=d),
            x1, log=lambda *a, **k: None, device="cuda")
        e = ecm_edwards.run_ecm_edwards(
            Options(exponent=p, mode="ecm", b1=50, b2=500, curves=1,
                    curve_seed=5, save_dir=d),
            log=lambda *a, **k: None, device="cuda")
        regs = [[eng.get_int(i) for i in range(eng.reg_count)]
                for eng in made]
        runs.append(((r.factor, r.res64), (e.factor, e.stage), regs))
        if graphs:
            assert all(len(eng._graphs) > 5 for eng in made)
    assert runs[0] == runs[1] == runs[2]


@pytest.mark.gpu
@pytest.mark.parametrize("p", [127, 9941, 216091])
def test_cuda_anysize_engine_graphs_match_eager(p):
    """On the card: the any-size engine (engine/torch_engine.py) with each
    op a CUDA graph and eager, on the same op sequence (squarings with a =
    3 and 1, LL steps, a multiplicand and mul), digit for digit and
    against big-int; n = 8, 512 and 10240 (radix 5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import random
    from prmers_tpu_torch.engine.torch_engine import TorchEngine
    mp = (1 << p) - 1
    rnd = random.Random(p)
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    a_vec = [3, 1, 1, 3] * 5
    engines = [TorchEngine(p, 3, device="cuda", graphs=g)
               for g in (True, False)]
    for e in engines:
        e.set_int(0, x)
        e.set_int(1, y)
        e.square_mul_seq(0, a_vec)
        e.square_sub2_seq(1, 4)
        e.set_multiplicand(2, 1)
        e.mul(0, 2, 3)
        e.square_mul_seq(0, a_vec)
    assert len(engines[0]._graphs) == 5 and not engines[1]._graphs
    for a in a_vec:
        x = x * x * a % mp
    for _ in range(4):
        y = (y * y - 2) % mp
    x = x * y * 3 % mp
    for a in a_vec:
        x = x * x * a % mp
    for r in (0, 1):
        assert np.array_equal(engines[0].get_digits(r),
                              engines[1].get_digits(r)), r
    assert engines[0].get_int(0) == x and engines[0].get_int(1) == y


@pytest.mark.gpu
@pytest.mark.parametrize("p", [127, 1279, 9941, 11213, 100003, 756839,
                               3021377])
def test_cuda_f3_stages_match_plain(p):
    """On the card: K10-K12 (the fft3161 transform, csrc/f3_ntt.cu)
    against their plain versions (ops/ntt2.py) on the same inputs, stage
    by stage, word for word (both canonical): n = 8 (radices 2, 4), 32,
    256 (4^4), 288 (3, 3, 2, 4, 4), 3072 (3 then 4s), 24576, 98304 (3, 2
    then 4s); the first forward stage from digits, K12 squaring and
    times a multiplicand, the last inverse stage to the CRT's (lo, hi)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from prmers_tpu_torch.engine.engine3161 import get_tables
    from prmers_tpu_torch.ops import ntt2
    t = get_tables(p, None, "cuda")
    n = t.n
    rng = np.random.default_rng(p)
    d = torch.from_numpy(rng.integers(0, 1 << 62, n, dtype=np.int64)).cuda()
    d &= t.masks
    x31 = torch.zeros((2, n), dtype=torch.int32, device="cuda")
    x61 = torch.zeros((2, n), dtype=torch.int64, device="cuda")
    for i in range(len(t.stages)):
        want = ntt2.fwd_stage_plain(t, i, x31, x61, d if i == 0 else None)
        tk.f3_fwd_stage(t, i, x31, x61, d if i == 0 else None)
        torch.cuda.synchronize()
        assert torch.equal(x31, want[0]) and torch.equal(x61, want[1]), i
    m31, m61 = x31.clone(), x61.clone()
    for m in ((m31, m61), (None, None)):
        want = ntt2.pointwise_plain(x31, x61, *m)
        tk.f3_pointwise(t, x31, x61, *m)
        torch.cuda.synchronize()
        assert torch.equal(x31, want[0]) and torch.equal(x61, want[1])
    lo = torch.empty(n, dtype=torch.int64, device="cuda")
    hi = torch.empty_like(lo)
    for i in range(len(t.stages) - 1, -1, -1):
        want = ntt2.inv_stage_plain(t, i, x31, x61)
        tk.f3_inv_stage(t, i, x31, x61, *((lo, hi) if i == 0 else ()))
        torch.cuda.synchronize()
        got = (lo, hi) if i == 0 else (x31, x61)
        assert torch.equal(got[0], want[0]) and \
            torch.equal(got[1], want[1]), i


@pytest.mark.gpu
@pytest.mark.parametrize("p", [127, 11213, 100003])
def test_cuda_engine3161_graphs_match_eager(p):
    """On the card: Engine3161 with each op a CUDA graph and eager, on the
    same op sequence (squarings with a = 3 and 1, LL steps, a multiplicand
    and mul, add, sub_reg, sub, add_small), digit for digit and against
    big-int."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import random
    from prmers_tpu_torch.engine.engine3161 import Engine3161
    mp = (1 << p) - 1
    rnd = random.Random(p)
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    a_vec = [3, 1, 1, 3] * 5
    engines = [Engine3161(p, 3, device="cuda", graphs=g)
               for g in (True, False)]
    for e in engines:
        e.set_int(0, x)
        e.set_int(1, y)
        e.square_mul_seq(0, a_vec)
        e.square_sub2_seq(1, 4)
        e.set_multiplicand(2, 1)
        e.mul(0, 2, 3)
        e.add(0, 1)
        e.sub_reg(1, 0)
        e.sub(0, 5)
        e.add_small(1, 7)
        e.square_mul_seq(0, a_vec)
    assert len(engines[0]._graphs) == 10 and not engines[1]._graphs
    for a in a_vec:
        x = x * x * a % mp
    for _ in range(4):
        y = (y * y - 2) % mp
    x = (x * y * 3 + y) % mp
    y = (y - x + 7) % mp
    x = (x - 5) % mp
    for a in a_vec:
        x = x * x * a % mp
    for r in (0, 1):
        assert np.array_equal(engines[0].get_digits(r),
                              engines[1].get_digits(r)), r
    assert engines[0].get_int(0) == x and engines[0].get_int(1) == y
