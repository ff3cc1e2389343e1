"""The port's plain torch Goldilocks ops (prmers_tpu_torch/ops/gl64.py)
against the JAX package's GL(np) and Python big-int, on lazy inputs: values
near P, and values >= P up to 2^64 - 1. Outputs may be lazy too, so they
are compared mod P, and every word must lie in [0, 2^32)."""

import numpy as np
import pytest
import torch

from prmers_tpu.ops.pallas.gl64 import GL
from prmers_tpu_torch.ops import gl64 as tgl

P = (1 << 64) - (1 << 32) + 1
EDGE = [0, 1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 63) - 1,
        1 << 63, P - 2, P - 1, P, P + 1, P + (1 << 31), (1 << 64) - 2,
        (1 << 64) - 1]


def _values(seed, count=600):
    rng = np.random.default_rng(seed)
    rnd = [int(v) for v in rng.integers(0, 1 << 63, size=count,
                                        dtype=np.uint64) * 2
           + rng.integers(0, 2, size=count, dtype=np.uint64)]
    near = [P - 1 - int(d) for d in rng.integers(0, 1 << 20, size=50)]
    lazy = [P + int(d) for d in rng.integers(0, (1 << 32) - 1, size=50)]
    return EDGE + rnd + near + lazy


@pytest.fixture(scope="module")
def operands():
    a = _values(1)
    b = _values(2)
    b = b[len(b) // 3:] + b[:len(b) // 3]      # pair edges with others
    return a, b


def _pair(vals):
    x = tgl.from_numpy_u64(np.array(vals, dtype=np.uint64), "cpu")
    return tgl.split(x)


def _ints(pair):
    lo, hi = pair
    assert bool(((lo >= 0) & (lo < (1 << 32))).all())
    assert bool(((hi >= 0) & (hi < (1 << 32))).all())
    return [int(l_) | (int(h) << 32) for l_, h in
            zip(lo.tolist(), hi.tolist())]


def _np_pair(vals):
    a = np.array(vals, dtype=np.uint64)
    return ((a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (a >> np.uint64(32)).astype(np.uint32))


def _np_ints(pair):
    return [int(l_) | (int(h) << 32) for l_, h in
            zip(pair[0].tolist(), pair[1].tolist())]


def test_split_join_roundtrip(operands):
    a, _ = operands
    x = tgl.from_numpy_u64(np.array(a, dtype=np.uint64), "cpu")
    assert torch.equal(tgl.join(*tgl.split(x)), x)
    assert [int(v) for v in tgl.to_numpy_u64(x)] == a


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr"])
def test_binary_ops(operands, op):
    a, b = operands
    g = GL(np)
    A, B = _pair(a), _pair(b)
    if op == "sqr":
        got = _ints(tgl.sqr(*A))
        ref = _np_ints(g.sqr(*_np_pair(a)))
        want = [x * x % P for x in a]
    else:
        got = _ints(getattr(tgl, op)(*A, *B))
        ref = _np_ints(getattr(g, op)(*_np_pair(a), *_np_pair(b)))
        f = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
             "mul": lambda x, y: x * y}[op]
        want = [f(x, y) % P for x, y in zip(a, b)]
    assert [v % P for v in got] == want
    assert [v % P for v in ref] == want


@pytest.mark.parametrize("e", [0, 1, 5, 31, 32, 33, 47, 48, 63, 64, 95])
def test_shiftmul(operands, e):
    a, _ = operands
    got = _ints(tgl.shiftmul(*_pair(a), e))
    ref = _np_ints(GL(np).shiftmul(*_np_pair(a), e))
    want = [x * pow(2, e, P) % P for x in a]
    assert [v % P for v in got] == want == [v % P for v in ref]


def test_mul_small_halve_double_canon(operands):
    a, _ = operands
    g = GL(np)
    A = _pair(a)
    got = _ints(tgl.mul_small(*A, 3))
    assert [v % P for v in got] == [3 * x % P for x in a]
    mask = torch.tensor([i % 3 != 0 for i in range(len(a))])
    inv2 = pow(2, P - 2, P)
    got = _ints(tgl.halve_where(*A, mask))
    ref = _np_ints(g.halve_where(*_np_pair(a), mask.numpy()))
    want = [(x * inv2 if m else x) % P for x, m in zip(a, mask.tolist())]
    assert [v % P for v in got] == want == [v % P for v in ref]
    got = _ints(tgl.double_where(*A, mask))
    ref = _np_ints(g.double_where(*_np_pair(a), mask.numpy()))
    want = [(2 * x if m else x) % P for x, m in zip(a, mask.tolist())]
    assert [v % P for v in got] == want == [v % P for v in ref]
    got = _ints(tgl.canon(*A))
    assert got == [x % P for x in a] == _np_ints(g.canon(*_np_pair(a)))


def test_matmul_mod_against_bigint():
    rng = np.random.default_rng(4)
    for K, J, N in ((3, 64, 5), (2, 128, 4)):
        A = rng.integers(0, 1 << 64, size=(K, J), dtype=np.uint64)
        Bm = rng.integers(0, 1 << 64, size=(J, N), dtype=np.uint64)
        A[0, :4] = np.uint64((1 << 64) - 1)          # lazy entries >= P
        Bm[:4, 0] = np.uint64(P)
        got = tgl.to_numpy_u64(tgl.canon64(tgl.matmul_mod(
            tgl.from_numpy_u64(A, "cpu"), tgl.from_numpy_u64(Bm, "cpu"))))
        Ao = A.astype(object)
        Bo = Bm.astype(object)
        want = [[sum(Ao[k, j] * Bo[j, c] for j in range(J)) % P
                 for c in range(N)] for k in range(K)]
        assert [[int(v) for v in row] for row in got] == want
