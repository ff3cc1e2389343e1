"""The port's core/field2.py against the JAX package's: the scalar field
Fq2 (roots, inverses, the CRT), the numpy pair ops Fq2Ops (the host
oracle) and the torch pair ops Fq2Torch (the plain versions' field) on
edge values (0, 1, q - 1, q) and random ones, equal mod q and canonical
where the inputs are."""

import os

import numpy as np
import pytest
import torch

from prmers_tpu.core import field2 as jf
from prmers_tpu_torch.core import field2 as tf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QS = [(tf.M31, 31, tf.T31), (tf.M61, 61, tf.T61)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64)
                            .view(np.int64).copy())


def _u(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint64)


def _operands(q: int, seed: int):
    """Every pair of the edge values, then random canonical pairs."""
    edge = np.array([0, 1, 2, q - 2, q - 1, q], dtype=np.uint64)
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.repeat(edge, edge.size),
                        rng.integers(0, q, 2000, dtype=np.uint64)])
    b = np.concatenate([np.tile(edge, edge.size),
                        rng.integers(0, q, 2000, dtype=np.uint64)])
    return a, b


def test_copy_keeps_every_reference_definition():
    """Every definition of the reference's core/field2.py is in the port
    unchanged (the ast; tests/test_torch_host.py's comparison); the port
    only adds Fq2Torch, T31 and T61."""
    from test_torch_host import _definitions
    a = _definitions(os.path.join(ROOT, "prmers_tpu", "core", "field2.py"))
    b = _definitions(os.path.join(ROOT, "prmers_tpu_torch", "core",
                                  "field2.py"))
    assert set(a) <= set(b)
    assert {k for k in a if a[k] != b[k]} == set()
    assert {"Fq2Torch", "T31", "T61"} <= set(b) - set(a)


def test_scalar_field_and_constants_are_the_reference():
    assert (tf.M31, tf.M61, tf.S31, tf.S61) == (jf.M31, jf.M61, jf.S31,
                                                jf.S61)
    assert tf.Q31_INV_MOD_Q61 == jf.Q31_INV_MOD_Q61
    for F, G in ((tf.F31, jf.F31), (tf.F61, jf.F61)):
        for n in (2, 3, 4, 8, 9, 24, 72, 288, 3072, 1 << 22, 9 << 20):
            assert F.root_unity(n) == G.root_unity(n)
            assert F.root_two(n) == G.root_two(n)
            assert F.order_is(F.root_unity(n), n)
        x = (123456789, 987654321 % F.q)
        assert F.inv(x) == G.inv(x) and F.mul(F.inv(x), x) == (1, 0)
        assert F.pow(x, 12345) == G.pow(x, 12345)
        assert F.sqr(x) == G.sqr(x)
    rng = np.random.default_rng(2)
    for _ in range(50):
        v = int(rng.integers(0, 1 << 62)) * (1 << 29) + 12345
        v %= tf.M31 * tf.M61
        assert tf.crt_pair(v % tf.M31, v % tf.M61) == v == \
            jf.crt_pair(v % jf.M31, v % jf.M61)
    for n in (2, 12, 97, 3072, 1 << 22):
        assert tf._prime_factors(n) == jf._prime_factors(n)


@pytest.mark.parametrize("q,s,T", QS)
@pytest.mark.parametrize("op", ["mulq", "addq", "subq"])
def test_base_ops_equal_fq2ops(q, s, T, op):
    """Fq2Torch's base ops equal the reference's Fq2Ops (numpy) mod q, and
    are canonical where both inputs are (q itself is 0 not canonical)."""
    a, b = _operands(q, 7)
    ref = getattr(jf.Fq2Ops(np, q, s), op)(a, b)
    port = getattr(tf.Fq2Ops(np, q, s), op)(a, b)
    got = _u(getattr(T, op)(_t(a), _t(b)))
    assert (port == ref).all()
    assert ((got % np.uint64(q)) == (ref % np.uint64(q))).all()
    canon = (a < q) & (b < q)
    assert (got[canon] < q).all()


@pytest.mark.parametrize("q,s,T", QS)
@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "mul_i", "neg"])
def test_pair_ops_equal_fq2ops(q, s, T, op):
    """The (re, im) pair ops on canonical pairs, word for word (neg is the
    reference ntt2._neg_pair)."""
    a, b = _operands(q, 11)
    c, d = _operands(q, 13)
    keep = (a < q) & (b < q) & (c < q) & (d < q)
    a, b, c, d = a[keep], b[keep], c[keep], d[keep]
    ops = jf.Fq2Ops(np, q, s)
    x, y = (a, b), (c, d)
    ref = {"mul": lambda: ops.mul(x, y), "sqr": lambda: ops.sqr(x),
           "add": lambda: ops.add(x, y), "sub": lambda: ops.sub(x, y),
           "mul_i": lambda: ops.mul_i(x),
           "neg": lambda: (ops.subq(0 * a, a), ops.subq(0 * b, b))}[op]()
    tx, ty = (_t(a), _t(b)), (_t(c), _t(d))
    got = {"mul": lambda: T.mul(tx, ty), "sqr": lambda: T.sqr(tx),
           "add": lambda: T.add(tx, ty), "sub": lambda: T.sub(tx, ty),
           "mul_i": lambda: T.mul_i(tx), "neg": lambda: T.neg(tx)}[op]()
    for g, r in zip(got, ref):
        assert (_u(g) == r).all()


@pytest.mark.parametrize("q,s,T", QS)
def test_norm_of_any_u64(q, s, T):
    """norm canonicalizes any u64 bit pattern (the sign bit included, so
    its shift is logical), as Fq2Ops.norm does."""
    rng = np.random.default_rng(17)
    x = np.concatenate([
        np.array([0, 1, q - 1, q, q + 1, 2 * q, (1 << 63) - 1, 1 << 63,
                  (1 << 64) - 1], dtype=np.uint64),
        rng.integers(0, 1 << 63, 1000, dtype=np.uint64) * np.uint64(2)
        + np.uint64(1)])
    got = _u(T.norm(_t(x)))
    assert (got == jf.Fq2Ops(np, q, s).norm(x)).all()
    assert (got == np.array([int(v) % q for v in x], dtype=np.uint64)).all()


@pytest.mark.parametrize("q,s,T", QS)
def test_python_int_operands(q, s, T):
    """A scalar operand may be a python int (the radix-3 root, the CRT
    constant), as in the plain stages."""
    a, _b = _operands(q, 19)
    a = a[a < q]
    w = jf.F61.root_unity(3) if q == tf.M61 else jf.F31.root_unity(3)
    got = T.mul(w, (_t(a), _t(a)))
    ops = jf.Fq2Ops(np, q, s)
    ref = ops.mul((np.uint64(w[0]), np.uint64(w[1])), (a, a))
    assert all((_u(g) == r).all() for g, r in zip(got, ref))
