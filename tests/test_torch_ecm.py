"""The port's ECM (prmers_tpu_torch/modes/ecm_edwards.py, the default
twisted Edwards, and modes/ecm.py, Montgomery) against the JAX package's
on the CPU, at M29 and M37 with the reference tests' bounds and seeds and
the torsion 8, 16 and 163 families. The reference runs on its numpy
engine with PRMERS_ECM_NO_BATCH=1 (its classic per-curve loop), the port
with the same switch and device="cpu" on its any-size engine ("jax") and,
at M37, its numpy engine, both through their apps' dispatch: the factor,
the curve and sigma that found it, the stage and the result JSON (time
stamp and checksum aside) must be equal. Where the reference batches its curves (backend "jax",
K > 1), the port batches them too (engine/batch.BatchTorchEngine), and
both batched runs give the same outcome; the classic loop's factor comes
out of both."""

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
    miss). Both packages run the classic per-curve loop
    (PRMERS_ECM_NO_BATCH=1); test_batched_path_says_classic holds the
    batched path."""
    monkeypatch.setenv("PRMERS_ECM_NO_BATCH", "1")
    want = _reference(name)
    p = CASES[name]["exponent"]
    for backend in BACKENDS if p == 37 else ("jax",):
        o = TOptions(mode="ecm", backend=backend,
                     save_dir=str(tmp_path / backend), **CASES[name])
        got = _outcome(*tapp.run(o, device="cpu", log=quiet))
        assert got == want, backend
    assert got[0] > 1 and ((1 << p) - 1) % got[0] == 0


@pytest.mark.parametrize("edwards", [True, False])
def test_batched_path_says_classic(edwards, monkeypatch, tmp_path):
    """The port's twin of the reference's test_batched_matches_classic
    (tests/test_ecm.py:62, tests/test_ecm_edwards.py:123): where the
    reference batches its curves (backend "jax", K > 1, no
    PRMERS_ECM_NO_BATCH), the port runs them as lanes of BatchTorchEngine
    and logs the reference's line, with the reference's batched outcome
    (BatchJaxEngine: factor, curve, sigma, stage and JSON); it says the
    classic loop's factor, and for Montgomery its curve and stage too
    (Edwards runs every lane's stage 1 before any stage 2, so only the
    factor must match there)."""
    monkeypatch.delenv("PRMERS_ECM_NO_BATCH", raising=False)
    name = "edwards_m37_stage2" if edwards else "montgomery_m37_stage2"
    logs, jlogs = [], []
    o = TOptions(mode="ecm", backend="jax", save_dir=str(tmp_path / "t"),
                 **CASES[name])
    got = _outcome(*tapp.run(o, device="cpu", log=logs.append))
    said = [str(ln) for ln in logs if "batched" in str(ln)]
    family = "ECM-Edwards" if edwards else "ECM"
    K = CASES[name]["curves"]
    assert said == [f"{family} batched: {K} curves per dispatch x 1 "
                    "batches"]
    assert not any("not yet ported" in str(ln) for ln in logs)
    jo = JOptions(mode="ecm", backend="jax", save_dir=str(tmp_path / "j"),
                  **CASES[name])
    assert got == _outcome(*japp.run_once(jo, log=jlogs.append))
    assert [str(ln) for ln in jlogs if "batched" in str(ln)] == said
    monkeypatch.setenv("PRMERS_ECM_NO_BATCH", "1")
    classic = _reference(name)
    o = TOptions(mode="ecm", backend="jax", save_dir=str(tmp_path / "c"),
                 **CASES[name])
    logs.clear()
    assert _outcome(*tapp.run(o, device="cpu", log=logs.append)) == classic
    assert not any("batched" in str(ln) for ln in logs)
    assert got[0] == classic[0] and ((1 << 37) - 1) % got[0] == 0
    if not edwards:
        assert (got[1], got[3]) == (classic[1], classic[3])


@pytest.mark.parametrize("edwards", [True, False])
@pytest.mark.parametrize("p, backend, arith, env, batches", [
    (756839, "auto", "auto", {}, True),
    (9941, "jax", "gl64", {}, True),
    (9941, "auto", "auto", {"PRMERS_ECM_NO_BATCH": "1"}, False),
    (9941, "auto", "auto", {"PRMERS_ECM_BATCH_LANES": "1"}, False),
    (9941, "auto", "fft3161", {}, False),
    (9941, "numpy", "auto", {}, False)])
def test_batch_route(edwards, p, backend, arith, env, batches,
                     monkeypatch):
    """The reference's gates in both batch drivers, with the batch engine
    stubbed: backend "auto" or "jax", arith "auto" or "gl64", K > 1 and
    at least two lanes build the batch, also at n = 2^15 (p = 756839),
    where the classic loop would run the four-step kernel engine (the
    batch measured faster there); PRMERS_ECM_NO_BATCH, one lane, -arith
    fft3161 and backend "numpy" decline before any engine is built, with
    nothing logged."""
    from prmers_tpu_torch.engine import batch as tbatch
    from prmers_tpu_torch.modes import ecm as tecm
    from prmers_tpu_torch.modes import ecm_edwards as ted

    class Built(Exception):
        pass

    def refuse(*a, **k):
        raise Built

    for name in ("PRMERS_ECM_NO_BATCH", "PRMERS_ECM_BATCH_LANES",
                 "PRMERS_ECM_BATCH_MEM"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(tbatch, "BatchTorchEngine", refuse)
    o = TOptions(exponent=p, mode="ecm", b1=20, b2=0, curves=4,
                 backend=backend, arith=arith, edwards=edwards)
    logs = []
    res = tecm.EcmResult(p, 20, 0, 4)
    args = (o, logs.append, (1 << p) - 1, 4) + (
        (res, None) if edwards else ("suyama", 1, res, None))
    drive = ted._run_edwards_batch if edwards else tecm._run_ecm_batch
    if batches:
        with pytest.raises(Built):
            drive(*args, device="cpu")
    else:
        assert drive(*args, device="cpu") is False
        assert logs == []


@pytest.mark.slow
@pytest.mark.parametrize("case", ["edwards_m701", "edwards_m67",
                                  "montgomery_m67"])
def test_golden_factor_numpy(case, tmp_path):
    """The reference's slow goldens (tests/test_ecm_edwards.py:92-121,
    tests/test_ecm.py:54-60) on the port's numpy engine: M701 -b1 6000
    -b2 33333 -K 8 and M67 -b1 2000 -b2 50000 -K 12, seed 1."""
    p, b1, b2, K = (701, 6000, 33333, 8) if case == "edwards_m701" else \
        (67, 2000, 50000, 12)
    o = TOptions(exponent=p, mode="ecm", b1=b1, b2=b2, curves=K,
                 curve_seed=1, backend="numpy", save_dir=str(tmp_path),
                 edwards=case.startswith("edwards"))
    r, _j = tapp.run(o, device="cpu", log=quiet)
    if p == 701:
        assert r.factor == 68453816366333403527
    else:
        assert r.factor == 193707721
        assert case == "edwards_m67" or r.stage == 2
    assert ((1 << p) - 1) % r.factor == 0


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
