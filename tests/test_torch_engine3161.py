"""The port's Engine3161 (prmers_tpu_torch/engine/engine3161.py) on the
CPU against the JAX package's: its numpy oracle (xp=np) and its torch
path on the plain versions of K10-K12, op for op against the reference's
numpy Engine3161 and big-int, checkpoints with a multiplicand crossing
both ways, M127 LL and M1279 PRP through create_engine(arith="fft3161"),
and one chain against the reference's jax.numpy engine."""

import random

import numpy as np
import pytest
import torch

from prmers_tpu.engine.engine3161 import Engine3161 as JEngine3161
from prmers_tpu_torch.engine.engine3161 import Engine3161
from prmers_tpu_torch.engine.factory import create_engine
from prmers_tpu_torch.io.options import Options
from prmers_tpu_torch.modes.prp_ll import run_prp_or_ll


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops(e, x, y):
    """An op sequence of the modes: squarings with a = 3 and 1, an LL
    step, a multiplicand and mul with a, add, sub_reg, sub, add_small,
    addsub, copy of a multiplicand, and a mul by the copy."""
    e.set_int(0, x)
    e.set_int(1, y)
    e.square_mul_seq(0, [3, 1, 1, 3])
    e.square_sub2_seq(1, 2)
    e.set_multiplicand(2, 1)
    e.mul(0, 2, 3)
    e.add(0, 1)
    e.sub_reg(1, 0)
    e.sub(0, 5)
    e.add_small(1, 7)
    e.addsub(4, 5, 0, 1)
    e.copy(3, 2)
    e.mul(5, 3)
    return [e.get_int(r) for r in (0, 1, 4, 5)]


def _bigint(p, x, y):
    mp = (1 << p) - 1
    for a in (3, 1, 1, 3):
        x = x * x * a % mp
    for _ in range(2):
        y = (y * y - 2) % mp
    w = y
    x = (x * y * 3 + y) % mp
    y = (y - x + 7) % mp
    x = (x - 5) % mp
    return [x, y, (x + y) % mp, (x - y) * w % mp]


@pytest.mark.parametrize("p", [127, 1279, 2203, 9941, 11213, 100003])
def test_op_sequence_matches_reference_and_bigint(p):
    """n = 8, 32, 64, 256, 288 (9 * 2^5), 3072 (3 * 2^10): the torch path,
    the numpy oracle and the reference's numpy engine give the same
    values, and big-int's; the digit vectors are equal too."""
    mp = (1 << p) - 1
    rnd = random.Random(p)
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    engines = [Engine3161(p, 6, device="cpu"), Engine3161(p, 6, xp=np),
               JEngine3161(p, 6, xp=np)]
    got = [_ops(e, x, y) for e in engines]
    assert got[0] == got[1] == got[2] == _bigint(p, x, y)
    for r in range(6):
        assert np.array_equal(engines[0].get_digits(r),
                              engines[2].get_digits(r))
        assert engines[0].get_raw_tagged(r)[1] == \
            engines[2].get_raw_tagged(r)[1]
    assert engines[0].get_size() == engines[2].get_size()
    assert np.array_equal(engines[0].widths, engines[2].widths)


def test_checkpoint_round_trip_with_a_multiplicand():
    """A checkpoint holding a multiplicand (its slab row keeps the source
    digits, flagged spectral) goes from the port to the reference's numpy
    engine and back; the restored engines go on to equal values."""
    p = 11213
    mp = (1 << p) - 1
    rnd = random.Random(7)
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    port, ref = Engine3161(p, 4, device="cpu"), JEngine3161(p, 4, xp=np)
    for e in (port, ref):
        e.set_int(0, x)
        e.set_int(1, y)
        e.set_multiplicand(2, 1)
        e.square_mul(0, 3)
    blob = port.get_checkpoint()
    assert blob == ref.get_checkpoint()
    ref2, port2 = JEngine3161(p, 4, xp=np), Engine3161(p, 4, device="cpu")
    ref2.set_checkpoint(blob)
    port2.set_checkpoint(ref.get_checkpoint())
    for e in (port, ref, port2, ref2):
        e.mul(0, 2, 3)
    want = x * x * 3 * y * 3 % mp
    assert [e.get_int(0) for e in (port, ref, port2, ref2)] == [want] * 4
    assert port2.get_raw_tagged(2)[1] and not port2.get_raw_tagged(0)[1]


@pytest.mark.parametrize("p,mode", [(127, "ll"), (1279, "prp")])
def test_goldens_through_the_factory(p, mode):
    """M127 (LL) and M1279 (PRP) are prime on create_engine(arith=
    "fft3161"), the engine PRP/LL runs when -arith fft3161 is given."""
    eng = create_engine(p, 8, device="cpu", arith="fft3161", workload=mode)
    assert type(eng) is Engine3161 and not eng.is_np
    r = run_prp_or_ll(Options(exponent=p, mode=mode, proof=False,
                              save_dir=""), eng=eng,
                      log=lambda *a, **k: None)
    assert r.is_prime and r.res64 == ("0" * 16 if mode == "ll"
                                      else "0" * 15 + "1")


def test_factory_gives_the_oracle_for_numpy():
    """backend "numpy" gives the numpy oracle, any other backend the torch
    engine, by argument or PRMERS_ARITH."""
    e = create_engine(127, 2, backend="numpy", arith="fft3161")
    assert type(e) is Engine3161 and e.is_np
    for b in ("auto", "pallas", "jax", "sharded"):
        e = create_engine(127, 2, device="cpu", backend=b, arith="fft3161")
        assert type(e) is Engine3161 and not e.is_np


def test_chain_matches_the_jax_engine():
    """One chain against the reference's jax.numpy Engine3161 (XLA on the
    CPU; tests/test_fft3161.py's chain)."""
    import jax.numpy as jnp
    p = 1279
    ej = JEngine3161(p, 2, xp=jnp)
    et = Engine3161(p, 2, device="cpu")
    for e in (ej, et):
        e.set(0, 3)
        e.square_mul_seq(0, [1, 3, 1, 3, 1])
    assert ej.get_int(0) == et.get_int(0)
    assert np.array_equal(np.asarray(ej.get_digits(0)), et.get_digits(0))


def test_eager_on_the_cpu_and_tables_shared():
    """No graphs off the card; engines of one (p, n) share the device
    tables; the multiplicand planes are per register, so a copy is not an
    alias."""
    a, b = Engine3161(9941, 4, device="cpu"), Engine3161(9941, 4,
                                                         device="cpu")
    assert not a.graphs and a.t is b.t
    a.set(1, 5)
    a.set_multiplicand(2, 1)
    a.copy(3, 2)
    a.set(1, 7)
    a.set_multiplicand(2, 1)
    a.set(0, 3)
    a.mul(0, 3)
    assert a.get_int(0) == 15
    assert a._spec[3][1].data_ptr() != a._spec[2][1].data_ptr()
