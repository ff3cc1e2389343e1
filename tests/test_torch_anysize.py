"""The any-size engine (engine/torch_engine.py: TorchEngine,
TorchRowEngine) and the port's numpy oracle (engine/np_engine.py) on the
CPU against the JAX package's JaxEngine (jit on the CPU), its NumpyEngine
and big-int; checkpoints crossing with JaxEngine both ways; carry_full's
static rounds against its loop on saturated digits; and create_engine's
routing."""

import random

import numpy as np
import pytest
import torch

from prmers_tpu.core.field import FieldOps
from prmers_tpu.engine.jax_engine import JaxEngine
from prmers_tpu.engine.np_engine import NumpyEngine as JNumpyEngine
from prmers_tpu.ops import carry as jcarry
from prmers_tpu_torch.core.plan import build_plan, cached_plan
from prmers_tpu_torch.engine import factory
from prmers_tpu_torch.engine import torch_engine as te
from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine
from prmers_tpu_torch.engine.np_engine import NumpyEngine
from prmers_tpu_torch.ops import carry as tcarry
from prmers_tpu_torch.ops import gl64 as gl
from prmers_tpu_torch.ops import ntt

PS = [127, 521, 2699, 9941, 216091]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(e, p):
    """One sequence of every op of the Engine API the modes call; returns
    the digits after each step and the big-int values they must hold."""
    mp = (1 << p) - 1
    rnd = random.Random(p)
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    e.set_int(0, x)
    e.set_int(1, y)
    seen, want = [], []

    def look(*regs_vals):
        for r, v in regs_vals:
            seen.append(np.asarray(e.get_digits(r)))
            want.append(v % mp)

    a_vec = [3, 1, 3, 1, 1, 3]
    e.square_mul_seq(0, a_vec)
    for a in a_vec:
        x = x * x * a % mp
    look((0, x))
    e.square_sub2_seq(1, 3)
    for _ in range(3):
        y = (y * y - 2) % mp
    look((1, y))
    e.set_multiplicand(2, 1)
    e.mul(0, 2, 3)
    x = x * y * 3 % mp
    look((0, x))
    e.add(0, 1)
    x += y
    look((0, x))
    e.sub_reg(0, 1)
    x -= y
    look((0, x))
    e.addsub(2, 3, 0, 1)
    look((2, x + y), (3, x - y))
    e.sub(0, 2)
    x -= 2
    look((0, x))
    e.add_small(0, 7)
    x += 7
    look((0, x))
    e.square_mul(0, 1)
    x = x * x % mp
    look((0, x))
    return seen, want


@pytest.mark.parametrize("p", PS)
def test_torch_engine_equals_jax_numpy_and_bigint(p):
    """The same op sequence on TorchEngine(device="cpu"), the reference's
    JaxEngine and NumpyEngine: the same digits after every step, and each
    the digits of the big-int value."""
    ours, want = _drive(te.TorchEngine(p, 4, device="cpu"), p)
    jax_digits, _ = _drive(JaxEngine(p, 4), p)
    np_digits, _ = _drive(JNumpyEngine(p, 4), p)
    widths = cached_plan(p).widths
    from prmers_tpu_torch.utils import digits as dg
    for i, (a, b, c, v) in enumerate(zip(ours, jax_digits, np_digits, want)):
        assert np.array_equal(a, b) and np.array_equal(a, c), (p, i)
        assert dg.digits_to_int(a, widths) % ((1 << p) - 1) == v, (p, i)


def test_port_numpy_engine_is_the_reference_word_for_word():
    """The port's NumpyEngine against the reference's: the same digits and
    the same raw registers (a multiplicand's spectral words too)."""
    for p in (127, 2699):
        a, b = NumpyEngine(p, 4), JNumpyEngine(p, 4)
        da, _ = _drive(a, p)
        db, _ = _drive(b, p)
        assert all(np.array_equal(x, y) for x, y in zip(da, db))
        a.set_multiplicand(3, 0)
        b.set_multiplicand(3, 0)
        for r in range(4):
            assert np.array_equal(a.get_raw(r), b.get_raw(r)), r


def test_torch_engine_without_graphs_on_cpu():
    """The CPU never takes graphs (they are CUDA's); graphs=True on a CPU
    engine would fail at the first capture."""
    e = te.TorchEngine(127, 2, device="cpu")
    assert e.graphs is False
    e.set(0, 3)
    e.square_mul_seq(0, [1] * 5)
    assert e.get_int(0) == pow(3, 2 ** 5, (1 << 127) - 1)


def test_row_engine_matches_slab_engine():
    """TorchRowEngine (compact widths, one tensor per register) against
    TorchEngine, as tests/test_engine_jax.py:78-95 holds JaxRowEngine."""
    p = 1279
    a = te.TorchEngine(p, 4, device="cpu")
    b = te.TorchRowEngine(p, 4, device="cpu")
    assert b.t.masks is None and b.t.widths.dtype == torch.uint8
    for e in (a, b):
        e.set(0, 3)
        e.square_mul_seq(0, [1, 3, 1])
        e.set_int(1, 424242)
        e.set_multiplicand(2, 1)
        e.copy(3, 0)
        e.mul(3, 2, 7)
        e.addsub(1, 2, 3, 0)
        e.sub(1, 5)
        e.square_sub2_seq(0, 2)
        e.sub_reg(3, 1)
    for i in (0, 1, 2, 3):
        assert a.get_int(i) == b.get_int(i), i
    assert np.array_equal(a.get_digits(0), b.get_digits(0))


def test_row_engine_copy_alias_safety():
    """tests/test_engine_jax.py:98: a square of a copy leaves the source."""
    e = te.TorchRowEngine(521, 3, device="cpu")
    e.set_int(0, 999)
    e.copy(1, 0)
    e.square_mul(1, 1)
    assert e.get_int(0) == 999
    assert e.get_int(1) == 999 * 999


def test_slab_engine_copy_is_a_copy():
    e = te.TorchEngine(521, 3, device="cpu")
    e.set_int(0, 999)
    e.copy(1, 0)
    e.square_mul(1, 3)
    assert e.get_int(0) == 999 and e.get_int(1) == 999 * 999 * 3


@pytest.mark.parametrize("p", [127, 2699])
def test_checkpoints_cross_with_jax_engine(p):
    """A JaxEngine checkpoint (digits and a live multiplicand) loaded into
    TorchEngine, and the reverse: the loaded engine's mul against the
    restored multiplicand gives the big-int product."""
    mp = (1 << p) - 1
    for src_cls, dst_cls in ((JaxEngine, te.TorchEngine),
                             (te.TorchEngine, JaxEngine)):
        kw = {"device": "cpu"} if src_cls is te.TorchEngine else {}
        src = src_cls(p, 3, **kw)
        src.set_int(0, 12345)
        src.set_int(1, 6789)
        src.set_multiplicand(2, 1)
        blob = src.get_checkpoint()
        kw = {"device": "cpu"} if dst_cls is te.TorchEngine else {}
        dst = dst_cls(p, 3, **kw)
        dst.set_checkpoint(blob)
        assert np.array_equal(dst.get_raw(2), src.get_raw(2))
        dst.mul(0, 2)
        assert dst.get_int(0) == 12345 * 6789 % mp


# ---------------------------------------------------------------------------
# carry_full with a static round count
# ---------------------------------------------------------------------------

def _static_vs_loop(y, widths, a=1):
    """The port's carry_full with absorb_rounds against its loop form and
    the reference's numpy carry (carry_full_np too)."""
    w64 = widths.astype(np.uint64)
    masks = (np.uint64(1) << w64) - np.uint64(1)
    F = FieldOps(np)
    want = jcarry.carry_full(F, y.copy(), w64, masks.copy(), a)
    assert np.array_equal(tcarry.carry_full_np(F, y.copy(), w64, masks, a),
                          want)
    bound = max(int(y.max()), 1) * a
    r = tcarry.absorb_rounds(bound, int(widths.min()))
    yt = gl.from_numpy_u64(y, "cpu")
    wt = torch.from_numpy(widths.astype(np.int64))
    for rounds in (None, r):
        got = tcarry.carry_full(yt, wt, a=a, rounds=rounds)
        assert np.array_equal(gl.to_numpy_u64(got), want), rounds


def test_static_carry_all_ones_single_carry():
    n = 4096
    widths = np.full(n, 5, np.uint8)
    widths[1::7] = 6
    masks = (1 << widths.astype(np.uint64)) - 1
    y = masks.copy()
    y[0] += 1
    _static_vs_loop(y, widths)


def test_static_carry_mp_fixed_point():
    n = 512
    widths = np.full(n, 6, np.uint8)
    _static_vs_loop((1 << widths.astype(np.uint64)) - 1, widths)


def test_static_carry_random_with_mul():
    n = 2048
    rng = np.random.default_rng(3)
    widths = np.where(rng.random(n) < 0.5, 5, 6).astype(np.uint8)
    _static_vs_loop(rng.integers(0, 1 << 60, n, dtype=np.uint64), widths, 3)


@pytest.mark.parametrize("p,a", [(9941, 2), (9941, 9), (216091, 1)])
def test_static_carry_mp_minus_a_and_convolution_bound(p, a):
    """The digits of M_p - a plus the digits of a (a full ripple to M_p),
    and convolution-sized words times 9 at the plan's own rounds
    (NttTables.carry_rounds)."""
    from prmers_tpu_torch.utils import digits as dg
    plan = cached_plan(p)
    mp = (1 << p) - 1
    y = dg.int_to_digits(mp - a, plan.widths) + \
        dg.int_to_digits(a, plan.widths)
    _static_vs_loop(y, plan.widths.astype(np.uint8))
    t = ntt.NttTables.from_plan(plan, np)
    assert tcarry.absorb_rounds(plan.max_word * 9, int(plan.widths.min())) \
        == t.carry_rounds
    rng = np.random.default_rng(p)
    y = rng.integers(0, plan.max_word, plan.n, dtype=np.uint64)
    y[: 64] = plan.max_word - 1                       # the bound's worst
    yt = gl.from_numpy_u64(y, "cpu")
    wt = torch.from_numpy(plan.widths.astype(np.int64))
    F = FieldOps(np)
    w64 = plan.widths.astype(np.uint64)
    want = jcarry.carry_full(F, y, w64, (np.uint64(1) << w64) - np.uint64(1),
                             9)
    got = tcarry.carry_full(yt, wt, a=9, rounds=t.carry_rounds)
    assert np.array_equal(gl.to_numpy_u64(got), want)


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    for k in ("PRMERS_NO_PALLAS", "PRMERS_SHARDED_IMPL", "PRMERS_BACKEND",
              "PRMERS_ARITH", "PRMERS_NO_ROWCARRY", "PRMERS_XLA_CARRY"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_auto_routes_by_check_shape(clean_env):
    """"auto" gives the four-step engine where check_shape takes the plan
    (n = 2^15) and the any-size engine at n = 2^14, 10240 and 81920."""
    assert cached_plan(756839).n == 1 << 15
    assert type(factory.create_engine(756839, 2, device="cpu")) is \
        FourStepEngine
    for p, n in ((300007, 1 << 14), (216091, 10240), (1600003, 81920)):
        assert cached_plan(p).n == n
        e = factory.create_engine(p, 2, device="cpu")
        assert type(e) is te.TorchEngine and e.get_size() == n
    e = factory.create_engine(1600003, 2, device="cpu")
    e.set(0, 3)
    e.square_mul(0, 3)
    assert e.get_int(0) == 27


def test_backends_and_no_pallas(clean_env):
    """"jax" and "numpy" give their engines at any p; PRMERS_NO_PALLAS
    sends a p the four-step engine covers to the any-size engine; the row
    engine from ROW_MODE_MIN_N."""
    e = factory.create_engine(756839, 2, device="cpu", backend="jax")
    assert type(e) is te.TorchEngine
    assert type(factory.create_engine(127, 2, backend="numpy")) is \
        NumpyEngine
    clean_env.setenv("PRMERS_NO_PALLAS", "1")
    e = factory.create_engine(756839, 2, device="cpu")
    assert type(e) is te.TorchEngine
    clean_env.setenv("PRMERS_BACKEND", "jax")
    clean_env.setattr(factory, "ROW_MODE_MIN_N", 1 << 12)
    assert type(factory.create_engine(9941, 2, device="cpu")) is \
        te.TorchEngine
    assert type(factory.create_engine(100003, 2, device="cpu")) is \
        te.TorchRowEngine


def test_factory_still_refuses(clean_env):
    """PRMERS_SHARDED_IMPL=xla still raises; "pallas" raises for a plan
    the four-step engine does not cover. "fft3161", once refused here,
    gives Engine3161 (tests/test_torch_engine3161.py)."""
    from prmers_tpu_torch.engine.engine3161 import Engine3161
    e = factory.create_engine(9941, 2, device="cpu", arith="fft3161")
    assert type(e) is Engine3161 and e.get_size() == 256
    with pytest.raises(NotImplementedError):
        factory.create_engine(9941, 2, device="cpu", backend="pallas")
    clean_env.setenv("PRMERS_SHARDED_IMPL", "xla")
    with pytest.raises(NotImplementedError, match="PRMERS_SHARDED_IMPL"):
        factory.create_engine(9941, 2, device="cpu")


def test_default_device_is_cuda_for_the_any_size_engine():
    """No silent CPU fallback: without a card and without device="cpu"
    the any-size engine raises too."""
    if torch.cuda.is_available():
        assert te.TorchEngine(127, 1).regs.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            te.TorchEngine(127, 1)
        with pytest.raises(RuntimeError):
            factory.create_engine(9941, 2)


def test_build_plan_shapes_the_engine_takes():
    """Plans the kernel engine never takes but core/plan makes: n = 8 ...
    2^14 at powers of two and 5 * 2^k below 163840 (a forced n too)."""
    for p, n in ((127, 8), (9941, 1 << 12), (100003, 5 << 11)):
        plan = build_plan(p, n=n) if n != cached_plan(p).n else cached_plan(p)
        e = te.TorchEngine(p, 1, plan=plan, device="cpu")
        e.set(0, 5)
        e.square_mul_seq(0, [3, 1])
        assert e.get_int(0) == pow(5 * 5 * 3, 2, (1 << p) - 1)


def test_prefix_scan_matches_the_sequential_scan():
    """ops/carry._prefix_scan (one cummax) against the scan it replaces,
    composed digit by digit: (g_b | (p_b & g_a), p_b & p_a), on random
    generate/propagate flags that are never both set, with long runs of
    propagates (across its rows of 1024 digits too) and none at all."""
    rng = np.random.default_rng(5)
    for n, prop in ((1, 0.5), (7, 0.0), (64, 1.0), (4096, 0.9), (999, 0.5),
                    (10240, 0.999), (1 << 16, 0.9999), (1 << 16, 1.0)):
        p = rng.random(n) < prop
        g = ~p & (rng.random(n) < 0.5)
        G, P = tcarry._prefix_scan(torch.from_numpy(g), torch.from_numpy(p))
        ga, pa = False, True
        want_g, want_p = [], []
        for gb, pb in zip(g.tolist(), p.tolist()):
            ga, pa = gb or (pb and ga), pb and pa
            want_g.append(ga)
            want_p.append(pa)
        assert G.tolist() == want_g and P.tolist() == want_p, (n, prop)
