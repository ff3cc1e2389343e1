"""The curve-batched engine (prmers_tpu_torch/engine/batch.py,
BatchTorchEngine) on the CPU against the JAX package's BatchJaxEngine (jit
on the CPU) and against B separate TorchEngines, with the same per-lane
inputs made from a numpy seed: every op of the surface, the digits of
every lane exactly equal after each one, at p = 127 (n = 8), 2203 (n = 80,
radix 5) and 9941 (n = 512). The lane forms of the transform are held
word for word against ops/ntt.py's single-register forward and inverse,
and carry_full on a (B, n) batch against each row alone. On a card
(`gpu`, skipped here): the engine's CUDA graphs against its eager ops, and
the card against the CPU."""

import numpy as np
import pytest
import torch

from prmers_tpu_torch.core.plan import cached_plan
from prmers_tpu_torch.engine import torch_engine as te
from prmers_tpu_torch.engine.batch import (BatchTorchEngine, forward_lanes,
                                           inverse_lanes)
from prmers_tpu_torch.ops import carry as tcarry
from prmers_tpu_torch.ops import gl64 as gl
from prmers_tpu_torch.ops import ntt

PS = [127, 2203, 9941]
B = 3
REGS = 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(p: int, seed: int) -> list[int]:
    """B values below M_p from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes((p + 7) // 8), "little") %
            ((1 << p) - 1) for _ in range(B)]


def _script(e, p: int):
    """Every op of the batched surface in one sequence; yields (label,
    digit registers) after each step for the caller to read."""
    e.set(0, 3)
    yield "set", (0,)
    for r, seed in ((1, 1), (2, 2)):
        for lane, v in enumerate(_lanes(p, p * 10 + seed)):
            e.set_int(r, v, lane)
    yield "set_int lane", (1, 2)
    e.set_int(3, _lanes(p, p * 10 + 3)[0])
    yield "set_int all", (3,)
    e.copy(4, 1)
    yield "copy", (4,)
    e.square_mul(1, 3)
    yield "square_mul a=3", (1,)
    e.square_mul(2)
    yield "square_mul", (2,)
    e.square_mul_seq(4, [3, 1, 1, 3])
    yield "square_mul_seq", (4,)
    e.set_multiplicand(5, 2)
    yield "set_multiplicand", ()
    e.mul(1, 5, 3)
    yield "mul a=3", (1,)
    e.mul(4, 5)
    yield "mul", (4,)
    e.add(1, 3)
    yield "add", (1,)
    e.sub_reg(4, 1)
    yield "sub_reg", (4,)
    e.addsub(2, 3, 1, 4)
    yield "addsub", (2, 3)
    e.sync()


def _digits(e, r: int, lane: int) -> np.ndarray:
    if isinstance(e, BatchTorchEngine):
        return gl.to_numpy_u64(e.regs[r, lane])
    return np.asarray(e.regs[r, lane])


@pytest.mark.parametrize("p", PS)
def test_batch_matches_batch_jax_engine(p):
    """BatchTorchEngine and BatchJaxEngine through the same script: every
    digit register of every lane equal word for word after each op, the
    multiplicand equal mod P, and get_int equal."""
    from prmers_tpu.core.field import P
    from prmers_tpu.engine.batch import BatchJaxEngine
    a = BatchTorchEngine(p, REGS, B, device="cpu")
    b = BatchJaxEngine(p, REGS, B)
    assert a.get_size() == b.get_size()
    assert np.array_equal(a.widths, b.widths)
    for (label, regs), _ in zip(_script(a, p), _script(b, p)):
        for r in regs:
            for lane in range(B):
                assert np.array_equal(_digits(a, r, lane),
                                      _digits(b, r, lane)), (label, r, lane)
                assert a.get_int(r, lane) == b.get_int(r, lane)
    for lane in range(B):
        assert np.array_equal(_digits(a, 5, lane),
                              _digits(b, 5, lane) % np.uint64(P))


@pytest.mark.parametrize("p", PS)
def test_batch_matches_separate_engines(p):
    """Lane l of the batch equals a TorchEngine given lane l's inputs,
    op for op, and both equal big-int."""
    mp = (1 << p) - 1
    a = BatchTorchEngine(p, REGS, B, device="cpu")
    singles = [te.TorchEngine(p, REGS, device="cpu") for _ in range(B)]
    xs, ys = _lanes(p, 1), _lanes(p, 2)
    for lane in range(B):
        for e, args in ((a, (lane,)), (singles[lane], ())):
            e.set_int(0, xs[lane], *args)
            e.set_int(1, ys[lane], *args)
    for e in [a] + singles:
        e.square_mul(0, 3)
        e.set_multiplicand(2, 1)
        e.mul(0, 2, 3)
        e.addsub(3, 4, 0, 1)
        e.sub_reg(4, 1)
        e.add(3, 0)
    for lane, s in enumerate(singles):
        x = xs[lane] ** 2 * 3 * ys[lane] * 3 % mp
        want = {0: x, 3: (2 * x + ys[lane]) % mp, 4: (x - 2 * ys[lane]) % mp}
        for r, v in want.items():
            assert np.array_equal(gl.to_numpy_u64(a.regs[r, lane]),
                                  s.get_digits(r)), (r, lane)
            assert a.get_int(r, lane) % mp == v


@pytest.mark.parametrize("p", PS)
def test_lane_transforms_match_ntt(p):
    """forward_lanes and inverse_lanes on B lanes equal ntt.forward and
    ntt.inverse on each lane alone, word for word after lower."""
    t = te.get_tables(cached_plan(p), torch.device("cpu"))
    F = te.field(torch.device("cpu"))
    x = torch.stack([gl.from_numpy_u64(
        np.random.default_rng(p + lane).integers(
            0, 1 << 16, t.n, dtype=np.uint64), "cpu") for lane in range(B)])
    s = forward_lanes(F, t, F.lift(x))
    y = F.lower(inverse_lanes(F, t, F.sqr(s)))
    s = F.lower(s)
    assert s.shape == (B, t.C, t.R) and y.shape == (B, t.n)
    for lane in range(B):
        s1 = ntt.forward(F, t, F.lift(x[lane]))
        y1 = F.lower(ntt.inverse(F, t, F.sqr(s1)))
        assert torch.equal(s[lane], F.lower(s1))
        assert torch.equal(y[lane], y1)


@pytest.mark.parametrize("a", [1, 3])
def test_carry_full_rows_independent(a):
    """carry_full on a (B, n) batch of saturated and random words equals
    carry_full on each row alone, with the static rounds and the loop; each
    row's carry wraps within the row."""
    plan = cached_plan(9941)
    w = torch.from_numpy(plan.widths.astype(np.int64))
    rng = np.random.default_rng(a)
    rows = [((1 << w) - 1).clone(), torch.zeros_like(w),
            torch.from_numpy(rng.integers(0, 1 << 62, plan.n,
                                          dtype=np.int64))]
    rows[1][-1] = 1 << 40
    y = torch.stack(rows)
    for rounds in (None, tcarry.absorb_rounds((1 << 62) * a, int(w.min()))):
        got = tcarry.carry_full(y, w, a=a, rounds=rounds)
        for lane in range(len(rows)):
            assert torch.equal(got[lane], tcarry.carry_full(
                y[lane], w, a=a, rounds=rounds)), (rounds, lane)


@pytest.mark.gpu
@pytest.mark.parametrize("p", PS)
def test_cuda_batch_graphs_match_eager(p):
    """On the card: the script through CUDA graphs (run twice, so the
    second pass replays every capture) against graphs=False, every lane
    of every register equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = BatchTorchEngine(p, REGS, B, device="cuda")
    b = BatchTorchEngine(p, REGS, B, device="cuda", graphs=False)
    for _ in range(2):
        for _step in zip(_script(a, p), _script(b, p)):
            pass
        assert a._graphs and not b._graphs
        assert torch.equal(a.regs, b.regs)


@pytest.mark.gpu
@pytest.mark.parametrize("p", PS)
def test_cuda_batch_matches_cpu(p):
    """The script on the card (graphs) against the CPU: the slabs equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = BatchTorchEngine(p, REGS, B, device="cuda")
    b = BatchTorchEngine(p, REGS, B, device="cpu")
    for _step in zip(_script(a, p), _script(b, p)):
        pass
    assert torch.equal(a.regs.cpu(), b.regs)
