"""The port's copy of ops/ntt.py on its torch field (ops/gl64.TorchField)
against the JAX package's ntt on numpy: the tables word for word, forward
and inverse exact mod P on the same inputs at the plans of the reference
goldens and the radix-5 band below the four-step engine (n = 10240,
81920), and the inverse of the forward of a square against a big-int
weighted cyclic convolution."""

import numpy as np
import pytest
import torch

from prmers_tpu.core.field import FieldOps
from prmers_tpu.core.plan import cached_plan as jcached_plan
from prmers_tpu.ops import ntt as jntt
from prmers_tpu_torch.core.plan import cached_plan
from prmers_tpu_torch.engine.torch_engine import field, get_tables
from prmers_tpu_torch.ops import gl64 as gl
from prmers_tpu_torch.ops import ntt

PS = [127, 521, 2699, 9941, 100003, 216091, 1600003]
NF = FieldOps(np)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(t):
    """Every table of NttTables as (name, array)."""
    out = [("weights", t.weights), ("inv_weights_n", t.inv_weights_n),
           ("widths", t.widths), ("masks", t.masks),
           ("mid_t1", t.mid_t1), ("mid_t2", t.mid_t2),
           ("mid_t1_inv", t.mid_t1_inv), ("mid_t2_inv", t.mid_t2_inv)]
    for name, stages in (("r", t.stages_r), ("c", t.stages_c)):
        for i, s in enumerate(stages):
            out += [(f"{name}{i}.tw", s.tw), (f"{name}{i}.tw_inv", s.tw_inv)]
    return out


@pytest.mark.parametrize("p", PS)
def test_tables_equal_reference(p):
    """NttTables.from_plan(plan, np) word for word against the JAX
    package's, and to_device keeps every bit pattern."""
    a = jntt.NttTables.from_plan(jcached_plan(p), np)
    b = ntt.NttTables.from_plan(cached_plan(p), np)
    assert (a.p, a.n, a.R, a.C, a.mid_tile, a.carry_rounds) == \
        (b.p, b.n, b.R, b.C, b.mid_tile, b.carry_rounds)
    assert [s.radix for s in a.stages_r + a.stages_c] == \
        [s.radix for s in b.stages_r + b.stages_c]
    dev = b.to_device("cpu")
    for (name, x), (_, y), (_, z) in zip(_tables(a), _tables(b),
                                         _tables(dev)):
        assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert np.array_equal(gl.to_numpy_u64(z), y), name
    c = ntt.NttTables.from_plan(cached_plan(p), np, compact_widths=True)
    assert c.masks is None and c.widths.dtype == np.uint8
    assert c.to_device("cpu").widths.dtype == torch.uint8


def _digits(plan, rng):
    w = plan.widths.astype(np.uint64)
    return rng.integers(0, 1 << 32, plan.n, dtype=np.uint64) & \
        ((np.uint64(1) << w) - np.uint64(1))


@pytest.mark.parametrize("p", PS)
def test_forward_inverse_equal_reference(p):
    """forward on the plan's digits and inverse on random spectral words:
    the port on TorchField (lowered to canonical words) equals the JAX
    package's numpy transform exactly."""
    plan = cached_plan(p)
    rng = np.random.default_rng(p)
    ref = jntt.NttTables.from_plan(jcached_plan(p), np)
    t = get_tables(plan, torch.device("cpu"))
    F = field(torch.device("cpu"))
    x = _digits(plan, rng)
    want = jntt.forward(NF, ref, x)
    got = F.lower(ntt.forward(F, t, F.lift(gl.from_numpy_u64(x, "cpu"))))
    assert np.array_equal(gl.to_numpy_u64(got), want)
    z = rng.integers(0, gl.P, (plan.C, plan.R), dtype=np.uint64)
    want = jntt.inverse(NF, ref, z)
    got = F.lower(ntt.inverse(F, t, F.lift(gl.from_numpy_u64(z, "cpu"))))
    assert np.array_equal(gl.to_numpy_u64(got), want)


@pytest.mark.parametrize("p", [127, 9941])
def test_square_is_weighted_cyclic_convolution(p):
    """inverse(forward(x)^2) is the exact IBDWT convolution: digit j sums
    x_i x_k 2^(q_i + q_k - q_j) over i + k = j mod n, the wrap taking
    2^p = 1 (n = 8 and 512)."""
    plan = cached_plan(p)
    n = plan.n
    x = _digits(plan, np.random.default_rng(3)).tolist()
    q = [0]
    for w in plan.widths.tolist()[:-1]:
        q.append(q[-1] + int(w))
    want = [0] * n
    for i in range(n):
        for k in range(n):
            j = (i + k) % n
            shift = q[i] + q[k] - q[j] - (p if i + k >= n else 0)
            assert shift in (0, 1)
            want[j] += (x[i] * x[k]) << shift
    assert max(want) < gl.P
    t = get_tables(plan, torch.device("cpu"))
    F = field(torch.device("cpu"))
    s = ntt.forward(F, t, F.lift(gl.from_numpy_u64(np.array(
        x, dtype=np.uint64), "cpu")))
    got = F.lower(ntt.inverse(F, t, F.sqr(s)))
    assert gl.to_numpy_u64(got).tolist() == want


def test_field_ops_exact_on_large_bounds():
    """TorchField's ops against python ints, through chains that let the
    limb bounds grow to where a carry round must come before a product."""
    rng = np.random.default_rng(11)
    F = field(torch.device("cpu"))
    a = rng.integers(0, gl.P, 257, dtype=np.uint64)
    b = rng.integers(0, gl.P, 257, dtype=np.uint64)
    A = F.lift(gl.from_numpy_u64(a, "cpu"))
    B = F.lift(gl.from_numpy_u64(b, "cpu"))
    want = [int(v) for v in a]
    bv = [int(v) for v in b]
    X = A
    for step in range(12):
        for _ in range(step):          # sums of 2^step terms
            X = F.add(X, X)
        X = F.sub(F.mul(X, X), B)
        want = [(pow(2 ** step * w, 2, gl.P) - y) % gl.P
                for w, y in zip(want, bv)]
    assert X.bound < 1 << 53
    assert gl.to_numpy_u64(F.lower(X)).tolist() == want
    got = F.lower(F.mul_scalar(F.pow_const(A, 37), gl.P - 5))
    assert gl.to_numpy_u64(got).tolist() == \
        [pow(int(v), 37, gl.P) * (gl.P - 5) % gl.P for v in a]
