"""The port's ECM (prmers_tpu_torch/modes/ecm_edwards.py, the default
twisted Edwards, and modes/ecm.py, Montgomery) against the JAX package's
on the CPU, at M29 and M37 with the reference tests' bounds and seeds and
the torsion 8, 16 and 163 families. The reference runs on its numpy
engine with PRMERS_ECM_NO_BATCH=1 (its classic per-curve loop), the port
with device="cpu" on its any-size engine ("jax") and, at M37, its numpy
engine,
both through their apps' dispatch: the factor, the curve and sigma that
found it, the stage and the result JSON (time stamp and checksum aside)
must be equal. The port has no batched ECM yet, so it runs the classic
loop whatever the environment says."""

import functools
import json
import shutil
import tempfile

import pytest

from prmers_tpu.core import app as japp
from prmers_tpu.io.options import Options as JOptions
from prmers_tpu_torch import app as tapp
from prmers_tpu_torch.io.options import Options as TOptions

BACKENDS = ("jax", "numpy")

# tests/test_ecm.py and tests/test_ecm_edwards.py, by name
CASES = {
    "edwards_m29": dict(exponent=29, b1=300, b2=0, curves=3, curve_seed=7),
    "edwards_m37_stage2": dict(exponent=37, b1=20, b2=400, curves=6,
                               curve_seed=3),
    "edwards_m29_torsion16": dict(exponent=29, b1=300, b2=0, curves=4,
                                  curve_seed=11, torsion=16),
    "edwards_m29_iv163": dict(exponent=29, b1=300, b2=0, curves=6,
                              curve_seed=21, torsion=163),
    "montgomery_m29": dict(exponent=29, b1=300, b2=0, curves=2,
                           curve_seed=7, edwards=False),
    "montgomery_m37_stage2": dict(exponent=37, b1=20, b2=400, curves=4,
                                  curve_seed=3, edwards=False),
    "montgomery_m29_torsion8": dict(exponent=29, b1=300, b2=0, curves=6,
                                    curve_seed=9, torsion=8, edwards=False),
    "montgomery_m37_torsion16": dict(exponent=37, b1=200, b2=3000, curves=8,
                                     curve_seed=3, torsion=16,
                                     edwards=False),
}


def quiet(*a, **k):
    pass


def _outcome(r, j) -> tuple:
    d = json.loads(j)
    d.pop("timestamp")
    d.pop("checksum")
    return (r.factor, r.factor_curve, r.factor_sigma, r.stage, r.factors,
            r.curves, d)


@functools.lru_cache(maxsize=None)
def _reference(name: str) -> tuple:
    """The reference's outcome, once per case, in a fresh directory of its
    own."""
    o = JOptions(mode="ecm", backend="numpy", save_dir=tempfile.mkdtemp(),
                 **CASES[name])
    try:
        return _outcome(*japp.run_once(o, log=quiet))
    finally:
        shutil.rmtree(o.save_dir, ignore_errors=True)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ecm_matches_reference(name, monkeypatch, tmp_path):
    """Every case on the any-size engine; the M37 ones on the numpy
    engine too (the M29 ones take ~8 s each there, for no path the others
    miss)."""
    monkeypatch.setenv("PRMERS_ECM_NO_BATCH", "1")
    want = _reference(name)
    monkeypatch.delenv("PRMERS_ECM_NO_BATCH")
    p = CASES[name]["exponent"]
    for backend in BACKENDS if p == 37 else ("jax",):
        o = TOptions(mode="ecm", backend=backend,
                     save_dir=str(tmp_path / backend), **CASES[name])
        got = _outcome(*tapp.run(o, device="cpu", log=quiet))
        assert got == want, backend
    assert got[0] > 1 and ((1 << p) - 1) % got[0] == 0


@pytest.mark.parametrize("edwards", [True, False])
def test_batched_path_says_classic(edwards, monkeypatch, tmp_path):
    """Where the reference would batch its curves (backend "jax", K > 1,
    no PRMERS_ECM_NO_BATCH), the port says that batched ECM is not yet
    ported and runs the classic loop, with the reference's classic
    result."""
    monkeypatch.delenv("PRMERS_ECM_NO_BATCH", raising=False)
    kw = dict(CASES["edwards_m37_stage2" if edwards
                   else "montgomery_m37_stage2"])
    logs = []
    o = TOptions(mode="ecm", backend="jax", save_dir=str(tmp_path), **kw)
    got = _outcome(*tapp.run(o, device="cpu", log=logs.append))
    said = [ln for ln in logs if "batched" in str(ln)]
    assert len(said) == 1 and "not yet ported" in said[0]
    monkeypatch.setenv("PRMERS_ECM_NO_BATCH", "1")
    name = "edwards_m37_stage2" if edwards else "montgomery_m37_stage2"
    assert got == _reference(name)


def test_resume_line_export_equal(tmp_path):
    """-resume_save of a Montgomery curve (GMP-ECM METHOD=ECM line with
    its sigma): the same bytes from both packages."""
    kw = dict(exponent=127, mode="ecm", b1=100, b2=0, curves=1,
              curve_seed=123456, edwards=False, torsion=0)
    a, b = tmp_path / "j.save", tmp_path / "t.save"
    japp.run_once(JOptions(backend="numpy", resume_save=str(a),
                           save_dir=str(tmp_path), **kw), log=quiet)
    tapp.run(TOptions(backend="jax", resume_save=str(b),
                      save_dir=str(tmp_path), **kw), device="cpu",
             log=quiet)
    assert "METHOD=ECM;" in a.read_text()
    assert a.read_bytes() == b.read_bytes()
