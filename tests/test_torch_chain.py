"""K9, the whole-chain kernel (prmers_tpu_torch.ops.kernels.square_chain),
on the CPU against the JAX package's kn.square_chain in Pallas interpret
mode, and the engine's routing of squarings through it.

At n = 2^15 (R2 = 1) and 2^17 (R2 = 2: the JAX chain's r2 butterflies are
not trivial) both take the same numpy-seeded digits and carries, run
a = [3, 1, 3], then a follow-up chain of 2 that consumes the carries.
Tolerance: none; the arithmetic is exact, so digits and unit carries must
agree bit for bit (through convert.state_from_jax), and the value must
equal big-int. The CUDA kernel itself is held against square_chain_plain
on the card (test_torch_kernels.py and chip_smoke.py).
"""

import os

import numpy as np
import pytest
import torch

from prmers_tpu.core.plan import build_plan
from prmers_tpu.utils import digits as dg
from prmers_tpu_torch import convert
from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk


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


@pytest.fixture
def chain_env():
    """The JAX side in interpret mode with its chain kernel allowed."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PRMERS_PALLAS_INTERPRET", "1")
    mp.delenv("PRMERS_NO_CHAIN", raising=False)
    yield
    mp.undo()


@pytest.fixture(scope="module", params=[15, 17])
def both(request):
    """The JAX tables (chain eligible) and the port's at one n."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PRMERS_PALLAS_INTERPRET", "1")
    mp.delenv("PRMERS_NO_CHAIN", raising=False)
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
    fp = tfs.FourStepPlan.from_plan(plan)
    t = tk.DevTables.from_host(tfs.build_tables(fp), "cpu")
    yield plan, fpj, tj, kn, fp, t
    mp.undo()


def _pending(plan, t, co) -> int:
    """Value of the unrolled row carries: row b's carry enters the first
    digit of row b + 1, the last row's wraps to bit 0."""
    R, C = t.shape[0] * t.shape[1], t.shape[2]
    q = dg.bit_positions(plan.widths)
    cov = np.asarray(co, dtype=np.uint64).reshape(-1)
    return sum(int(cov[b]) << (0 if b == R - 1 else int(q[(b + 1) * C]))
               for b in range(R))


def _value(plan, t, x, co) -> int:
    mp = (1 << plan.p) - 1
    x = np.asarray(x, dtype=np.uint64).reshape(-1)
    return (dg.digits_to_int(x, plan.widths) + _pending(plan, t, co)) % mp


def test_chain_matches_pallas_chain(both):
    """The port's square_chain (plain) against the JAX kn.square_chain,
    a = [3, 1, 3] then [1, 3]: bit for bit in digits and carries, and equal
    to big-int."""
    plan, fpj, tj, kn, fp, t = both
    import jax.numpy as jnp
    assert kn.chain_ok(fpj, tj) and tfs.chain_ok(fp)
    mp = (1 << plan.p) - 1
    rng = np.random.default_rng(plan.n.bit_length())
    v = int.from_bytes(rng.bytes(plan.p // 8 + 1), "little") % mp
    x = dg.int_to_digits(v, plan.widths).reshape(t.shape)
    co = rng.integers(0, 1 << 40, size=t.carry_shape, dtype=np.uint64)
    co[0, 0, 0] = (1 << 45) + 12345     # a wide carry in the wrap
    want = _value(plan, t, x, co)
    (x0, x1), (c0, c1) = convert.state_to_jax(x, co)
    jx = [jnp.asarray(a) for a in (x0, x1, c0, c1)]
    px, pco = tgl.from_numpy_u64(x, "cpu"), tgl.from_numpy_u64(co, "cpu")
    for a in ([3, 1, 3], [1, 3]):
        jx = kn.square_chain(fpj, tj, *jx,
                             jnp.asarray(np.array(a, dtype=np.uint32)))
        px, pco = tk.square_chain(t, px, pco, a)
        jd, jc = convert.state_from_jax(*jx)
        assert (jd == tgl.to_numpy_u64(px)).all()
        assert (jc == tgl.to_numpy_u64(pco)).all()
        for ak in a:
            want = want * want * ak % mp
        assert _value(plan, t, tgl.to_numpy_u64(px),
                      tgl.to_numpy_u64(pco)) == want


def test_chain_equals_square_steps(both):
    """K9's plain version leaves exactly the state of K steps of the
    three-kernel path, and count < len(a) runs only the first count."""
    plan, fpj, tj, kn, fp, t = both
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 1 << 16, size=t.shape,
                                      dtype=np.int64))
    co = torch.from_numpy(rng.integers(0, 1 << 30, size=t.carry_shape,
                                       dtype=np.int64))
    d, c = tk.square_chain(t, x, co, [3, 1, 7, 5], count=2)
    sx, sc = x, co
    for a in (3, 1):
        sx, sc = tk.square_step(t, sx, sc, a=a)
    assert torch.equal(d, sx) and torch.equal(c, sc)


@pytest.mark.parametrize("logn", [15, 17])
def test_chain_ok_matches_jax(logn, chain_env):
    from prmers_tpu.engine.pallas_engine import _get_tables
    from prmers_tpu.ops.pallas import kernels as kn
    n = 1 << logn
    fpj, tj = _get_tables(_p_of(n), n)
    fp = tfs.FourStepPlan.from_plan(build_plan(_p_of(n), n=n))
    assert kn.chain_ok(fpj, tj) is True
    assert tfs.chain_ok(fp) is True


@pytest.mark.parametrize("logn,ok", [(18, True), (19, True), (20, False),
                                     (21, False)])
def test_chain_ok_shape_rule(logn, ok):
    """From the plan alone: True to n = 2^19 (L2 = 8), False from 2^20
    (L2 = 16, and the JAX VMEM estimate of 84 MiB over its 80 MiB cap)."""
    n = 1 << logn
    fp = tfs.FourStepPlan.from_plan(build_plan(_p_of(n), n=n))
    assert tfs.chain_ok(fp) is ok
    assert fp.rs.L2 == max(1, n // (64 * 1024))


def test_chain_off_pipelines():
    """Pipeline(chain=False), and T = 4 carry units, keep the squarings on
    the three-kernel step."""
    n = 1 << 16
    plan = build_plan(_p_of(n), n=n)
    assert tfs.chain_ok(tfs.FourStepPlan.from_plan(plan))
    for pipe in (tfs.Pipeline(chain=False), tfs.Pipeline(carry_max=16384)):
        assert not tfs.chain_ok(tfs.FourStepPlan.from_plan(plan, pipe))


def test_engine_takes_chain_as_jax(chain_env, monkeypatch):
    """FourStepEngine._chain is the JAX PallasEngine's, with the chain on
    and off."""
    from prmers_tpu.engine.pallas_engine import PallasEngine
    n = 1 << 15
    p = _p_of(n)
    plan = build_plan(p, n=n)
    assert PallasEngine(p, 2, plan=plan)._chain is True
    assert FourStepEngine(p, 2, plan=plan, device="cpu")._chain is True
    monkeypatch.setenv("PRMERS_NO_CHAIN", "1")
    assert PallasEngine(p, 2, plan=plan)._chain is False
    assert FourStepEngine(p, 2, plan=plan, device="cpu",
                          pipe=tfs.Pipeline(chain=False))._chain is False


def test_engine_chunks_cross_boundary(monkeypatch):
    """square_mul_seq with mixed a runs one square_chain per chunk of
    CHAIN_K (set to 2 here) and matches big-int; square_mul is a chain of
    one."""
    n = 1 << 15
    p = _p_of(n)
    mp = (1 << p) - 1
    monkeypatch.setattr(tk, "CHAIN_K", 2)
    seen = []
    real = tk.square_chain

    def spy(t, x, co, a_vec, count=None, out=None, co_out=None):
        seen.append(list(a_vec[:count]))
        return real(t, x, co, a_vec, count, out, co_out)

    monkeypatch.setattr(tk, "square_chain", spy)
    e = FourStepEngine(p, 2, plan=build_plan(p, n=n), device="cpu")
    rng = np.random.default_rng(41)
    v = int.from_bytes(rng.bytes(p // 8), "little") % mp
    e.set(0, v)
    a = [3, 1, 1, 3, 1]
    e.square_mul_seq(0, a)
    e.square_mul(0, 3)
    assert seen == [[3, 1], [1, 3], [1], [3]]
    want = v
    for ak in a + [3]:
        want = want * want * ak % mp
    assert e.get_int(0) == want
    with pytest.raises(ValueError):
        e.square_mul(0, 1 << 32)
