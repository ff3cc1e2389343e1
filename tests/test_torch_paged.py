"""Host paging in the port (prmers_tpu_torch/engine/paged.py, wired into
engine/factory.create_engine): PagedEngine around both port engines
(TorchEngine and FourStepEngine on the CPU, the latter on its kernels'
plain versions) with 2-3 device slots, against the unpaged engine and
big-int, with a multiplicand's spectral flag crossing a page-out; the
port's budget (PRMERS_MAX_DEVICE_REGS, PRMERS_MEMLIM_MB, the bytes each
engine holds per register); the factory's wrap and its [ALLOC] line; and
a P-1 stage 2 with more registers than slots against the reference."""

import random

import numpy as np
import pytest

from prmers_tpu.engine.np_engine import NumpyEngine as JNumpyEngine
from prmers_tpu.engine.paged import PagedEngine as JPagedEngine
from prmers_tpu_torch.engine import paged
from prmers_tpu_torch.engine.factory import create_engine
from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine
from prmers_tpu_torch.engine.paged import PagedEngine, device_reg_budget
from prmers_tpu_torch.engine.torch_engine import TorchEngine


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(eng, vals):
    """tests/test_paged.py's op pattern: every register squared, a
    multiplicand, mul, add, sub_reg, addsub, sub."""
    for i, v in enumerate(vals):
        eng.set_int(i, v)
    for i in range(len(vals)):
        eng.square_mul(i, 3)
    eng.set_multiplicand(3, 2)
    eng.mul(len(vals) - 1, 3, 5)
    eng.add(len(vals) - 3, 0)
    eng.sub_reg(len(vals) - 2, 1)
    eng.addsub(4, 5, 1, 0)
    eng.sub(0, 7)


def _bigint(p, vals):
    mp = (1 << p) - 1
    x = [v * v * 3 % mp for v in vals]
    k = len(vals)
    x[k - 1] = x[k - 1] * x[2] * 5 % mp
    x[k - 3] = (x[k - 3] + x[0]) % mp
    x[k - 2] = (x[k - 2] - x[1]) % mp
    x[4], x[5] = (x[1] + x[0]) % mp, (x[1] - x[0]) % mp
    x[0] = (x[0] - 7) % mp
    return x


@pytest.mark.parametrize("make,p,logical,slots", [
    (lambda p, k: TorchEngine(p, k, device="cpu"), 1279, 10, 3),
    (lambda p, k: TorchEngine(p, k, device="cpu"), 9941, 8, 2),
    (lambda p, k: FourStepEngine(p, k, device="cpu"), 544139, 7, 3),
], ids=["torch-1279", "torch-9941", "fourstep-544139"])
def test_paged_matches_unpaged_and_bigint(make, p, logical, slots):
    rnd = random.Random(p)
    mp = (1 << p) - 1
    vals = [rnd.randrange(mp) for _ in range(logical)]
    eng = PagedEngine(make(p, slots), logical)
    ref = make(p, logical)
    for e in (eng, ref):
        _drive(e, vals)
    want = _bigint(p, vals)
    for i in range(logical):
        if i == 3:          # the multiplicand: spectral, no digits
            continue
        assert eng.get_int(i) == ref.get_int(i) == want[i], i
    assert eng.page_outs > 0 and eng.page_ins > 0


@pytest.mark.parametrize("make,p", [
    (lambda p, k: TorchEngine(p, k, device="cpu"), 127),
    (lambda p, k: FourStepEngine(p, k, device="cpu"), 544139),
], ids=["torch", "fourstep"])
def test_multiplicand_survives_page_out(make, p):
    """A multiplicand paged out and in keeps its spectral flag (the
    four-step engine's (R1, R2, C) spectral words) and multiplies as
    before (tests/test_paged.py:test_paged_multiplicand_survives_eviction
    on the port's engines)."""
    rnd = random.Random(3)
    mp = (1 << p) - 1
    eng = PagedEngine(make(p, 2), 6)
    x, y = rnd.randrange(mp), rnd.randrange(mp)
    eng.set_int(0, x)
    eng.set_int(1, y)
    eng.set_multiplicand(2, 1)
    for r in (3, 4, 5):
        eng.set_int(r, r)
    assert 2 in eng._host
    assert eng._host[2][1] == isinstance(eng.inner, FourStepEngine)
    eng.mul(0, 2)
    assert eng.get_int(0) == x * y % mp


def test_checkpoint_crosses_with_the_reference():
    """A paged engine's checkpoint restores in the reference's paged
    numpy engine and back."""
    p = 1279
    eng = PagedEngine(TorchEngine(p, 3, device="cpu"), 8)
    ref = JPagedEngine(JNumpyEngine(p, 3), 8)
    for i in range(8):
        eng.set_int(i, 1000 + i)
    ref.set_checkpoint(eng.get_checkpoint())
    ref.square_mul(5, 3)
    eng.set_checkpoint(ref.get_checkpoint())
    assert [eng.get_int(i) for i in range(8)] == \
        [1000 + i if i != 5 else 1005 ** 2 * 3 for i in range(8)]


def test_budget(monkeypatch):
    """PRMERS_MAX_DEVICE_REGS sets the count (at least 2), PRMERS_MEMLIM_MB
    the memory; otherwise free memory less the engine's overhead, over its
    bytes per register."""
    monkeypatch.delenv("PRMERS_MAX_DEVICE_REGS", raising=False)
    monkeypatch.delenv("PRMERS_MEMLIM_MB", raising=False)
    n = 1 << 23
    for b in ("jax", "pallas"):
        got = device_reg_budget(n, hbm_bytes=80 << 30, backend=b)
        want = (int((80 << 30) * 0.95) - paged.OVERHEAD_BYTES[b] * n) \
            // paged.register_bytes(n, b)
        assert got == want > 2
    assert paged.register_bytes(n, "pallas") > paged.register_bytes(n, "jax")
    assert device_reg_budget(n, hbm_bytes=1 << 20) == 2
    monkeypatch.setenv("PRMERS_MEMLIM_MB", "4096")
    assert device_reg_budget(n) == device_reg_budget(n, hbm_bytes=4 << 30)
    monkeypatch.setenv("PRMERS_MAX_DEVICE_REGS", "17")
    assert device_reg_budget(n) == 17
    monkeypatch.setenv("PRMERS_MAX_DEVICE_REGS", "1")
    assert device_reg_budget(n) == 2
    monkeypatch.delenv("PRMERS_MAX_DEVICE_REGS")
    monkeypatch.delenv("PRMERS_MEMLIM_MB")
    assert device_reg_budget(4096, device="cpu") > 1000


@pytest.mark.parametrize("backend,p,cls", [("jax", 1279, TorchEngine),
                                           ("pallas", 544139,
                                            FourStepEngine)])
def test_factory_pages_over_budget(backend, p, cls, monkeypatch, capsys):
    """create_engine gives PagedEngine over the budget's count of slots
    (factory.py:158-176), with the [ALLOC] line under
    PRMERS_GPU_ALLOC_DIAG=1, and the plain engine within it."""
    monkeypatch.setenv("PRMERS_MAX_DEVICE_REGS", "4")
    monkeypatch.setenv("PRMERS_GPU_ALLOC_DIAG", "1")
    eng = create_engine(p, 9, device="cpu", backend=backend)
    assert type(eng) is PagedEngine and type(eng.inner) is cls
    assert (eng.slots, eng.reg_count) == (4, 9)
    err = capsys.readouterr().err
    assert "[ALLOC] logical regs=9" in err and "device budget=4 regs" in err
    assert "host-paged LRU" in err
    assert type(create_engine(p, 4, device="cpu", backend=backend)) is cls
    monkeypatch.delenv("PRMERS_MAX_DEVICE_REGS")
    assert type(create_engine(p, 9, device="cpu", backend="numpy")) is not \
        PagedEngine


def test_pm1_stage2_paged_matches_reference(tmp_path, monkeypatch):
    """The M367 golden's V-trace stage 2 (from its stage-1 X, over the
    range -b2start 38000 keeps) on 4 device slots: the reference's
    factor."""
    from prmers_tpu.io.options import Options as JOptions
    from prmers_tpu.modes import pm1 as jpm1
    from prmers_tpu.utils import primes as jprimes
    from prmers_tpu_torch.io.options import Options as TOptions
    from prmers_tpu_torch.modes import pm1 as tpm1
    x = pow(3, jprimes.build_e(11981) * 2 * 367, (1 << 367) - 1)
    kw = dict(exponent=367, mode="pm1", b1=11981, b2=38971, b2_start=38000,
              save_dir=str(tmp_path))
    # the budget also caps the V-trace plan's registers, in both packages
    monkeypatch.setenv("PRMERS_MAX_DEVICE_REGS", "4")
    rj = jpm1.run_pm1_stage2_vtrace(JOptions(backend="numpy", **kw), x,
                                    log=lambda *a: None)
    made = []
    real = tpm1.create_engine

    def create(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(tpm1, "create_engine", create)
    rt = tpm1.run_pm1_stage2_vtrace(TOptions(backend="jax", **kw), x,
                                    log=lambda *a: None, device="cpu")
    assert (rt.factor, rt.stage, rt.res64) == (rj.factor, rj.stage, rj.res64)
    assert rt.factor % 78138581882953 == 0
    assert type(made[0]) is PagedEngine and made[0].reg_count > 4
    assert made[0].page_outs > 0


def test_numpy_inner_as_reference():
    """The port's PagedEngine over the reference's numpy engine behaves as
    the reference's PagedEngine (the class is the original)."""
    p = 1279
    rng = np.random.default_rng(3)
    vals = [int(rng.integers(1, 1 << 60)) for _ in range(12)]
    a, b = PagedEngine(JNumpyEngine(p, 4), 12), \
        JPagedEngine(JNumpyEngine(p, 4), 12)
    for e in (a, b):
        _drive(e, vals)
    assert [a.get_int(i) for i in range(12) if i != 3] == \
        [b.get_int(i) for i in range(12) if i != 3]
    assert (a.page_ins, a.page_outs, a.clean_evictions) == \
        (b.page_ins, b.page_outs, b.clean_evictions)
