"""The port's P-1 (prmers_tpu_torch/modes/pm1.py) against the JAX
package's on the CPU. Each case runs the same Options through both
packages' app dispatch: the reference on its numpy engine, the port with
device="cpu" on its any-size engine ("jax", TorchEngine) and on its numpy
engine. The factor, the stage, the stage-1 factor, the stage-1 X (or the
stage-2 residue) and the result JSON must be equal, the JSON's time stamp
and checksum aside. p = 544139 (n = 2^15) also runs through the four-step
kernel engine's plain versions (K9, K1-K3), in a process of its own with
its own time limit."""

import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

from prmers_tpu.core import app as japp
from prmers_tpu.io import interop as jinterop
from prmers_tpu.io.options import Options as JOptions
from prmers_tpu.modes import pm1 as jpm1
from prmers_tpu.utils import primes as jprimes
from prmers_tpu_torch import app as tapp
from prmers_tpu_torch.io import interop as tinterop
from prmers_tpu_torch.io.options import Options as TOptions
from prmers_tpu_torch.modes import pm1 as tpm1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("jax", "numpy")
M367 = dict(exponent=367, b1=11981, b2=38971)
M367_S2 = 50500996776315830904406967


def quiet(*a, **k):
    pass


def _json(line: str) -> dict:
    d = json.loads(line)
    d.pop("timestamp")
    d.pop("checksum")
    return d


def _outcome(r, j) -> tuple:
    return (r.factor, r.stage, getattr(r, "stage1_factor", 0), r.res64,
            getattr(r, "_stage1_x", None), r.gerbicz_errors,
            r.transform_size, _json(j))


@functools.lru_cache(maxsize=None)
def _reference(items: tuple) -> tuple:
    """The reference's outcome, once per case, in a fresh directory of its
    own."""
    o = JOptions(mode="pm1", backend="numpy", save_dir=tempfile.mkdtemp(),
                 **dict(items))
    try:
        return _outcome(*japp.run_once(o, log=quiet))
    finally:
        shutil.rmtree(o.save_dir, ignore_errors=True)


def _port(backend, save_dir, **kw) -> tuple:
    o = TOptions(mode="pm1", backend=backend, save_dir=save_dir, **kw)
    return _outcome(*tapp.run(o, device="cpu", log=quiet))


def _same(tmp_path, backends=BACKENDS, **kw):
    """The port's outcome on each backend equals the reference's; returns
    it."""
    want = _reference(tuple(sorted(kw.items())))
    for backend in backends:
        got = _port(backend, str(tmp_path / backend), **kw)
        assert got == want, backend
    return want


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_pm1.py:TestPm1Golden.REF_TABLE without its heavy rows:
# (exponent, b1, b2, stage-1 factor, stage-2 factor)
REF_TABLE = [
    (269, 2141, 0, 13822297, 0),
    (269, 192, 0, 0, 0),
    (269, 192, 457, 0, 0),
    (269, 4, 2141, 0, 13822297),
    (569, 9, 677, 0, 55470673),
    (1097, 3, 709, 0, 4576661533441),
    (2151, 256, 4073, 327405968242246366421788399,
     31810015665526476520196715312101168065463218256802641),
    (4133, 23, 2099, 0, 11173615097),
    (44159, 23, 31, 0, 1511297617),
    (544139, 3, 7, 22853839, 22853839),
]


@pytest.mark.parametrize("p,b1,b2,f1,f2", REF_TABLE)
def test_reference_table(p, b1, b2, f1, f2, tmp_path):
    got = _same(tmp_path, exponent=p, b1=b1, b2=b2)
    factor, stage, s1 = got[:3]
    if b2 <= b1:
        assert factor == f1
    elif f2 == 0:
        assert factor == 0 and s1 == f1
    else:
        assert factor % f2 == 0
        assert (s1 if stage == 2 else factor if stage == 1 else 0) == f1


def test_m541_stage1(tmp_path):
    got = _same(tmp_path, exponent=541, b1=899)
    assert got[:2] == (4312790327, 1)
    assert got[4] == pow(3, jprimes.build_e(899) * 2 * 541, (1 << 541) - 1)


@pytest.mark.parametrize("variant", ["", "lowmem", "ultralowmem"])
def test_m367_stage1_x(variant, tmp_path):
    """Every stage-1 form (GL-checked windows, lowmem, ultralowmem) gives
    the reference's X = 3^(E(B1) * 2p) (B1 cut to 2000 from the golden's
    11981 for time; the card runs the golden)."""
    got = _same(tmp_path, ("jax",), exponent=367, b1=2000,
                pm1_variant=variant)
    assert got[4] == pow(3, jprimes.build_e(2000) * 2 * 367, (1 << 367) - 1)


@pytest.fixture(scope="module")
def m367_resume(tmp_path_factory):
    """The M367 golden's stage-1 X (big-int), as the reference's GMP-ECM
    resume file."""
    d = tmp_path_factory.mktemp("m367")
    x = pow(3, jprimes.build_e(M367["b1"]) * 2 * 367, (1 << 367) - 1)
    path = str(d / "resume_p367_B1_11981.save")
    jinterop.write_ecm_resume(path, M367["b1"], 367, x)
    return path


M367_VARIANTS = {
    "vtrace": dict(),
    "classic": dict(stage2_variant="classic"),
    "b2start": dict(b2_start=38000),
    "lowmem_b2start": dict(pm1_variant="lowmem", b2_start=38000),
    "known_factors": dict(no_gcd_stage1=True,
                          known_factors=("646300400639",)),
    "nk": dict(stage2_variant="nk", nmax=6, k_nk=2),
}


@pytest.mark.parametrize("variant", sorted(M367_VARIANTS))
def test_m367_stage2(variant, m367_resume, tmp_path):
    """The stage-2 forms from the golden's stage-1 X (loaded from its
    resume file, as -resume_load does): V-trace (the default), classic,
    -b2start, lowmem's H^Q (with -b2start for time), known factors
    divided out, n^K."""
    got = _same(tmp_path, resume_load=m367_resume, **M367,
                **M367_VARIANTS[variant])
    factor, stage = got[:2]
    if variant == "known_factors":
        assert factor == 78138581882953
    elif variant in ("b2start", "lowmem_b2start"):
        assert stage == 2 and factor % 78138581882953 == 0
    elif variant != "nk":
        assert (factor, stage) == (M367_S2, 2)


def test_ultralowmem_fresh(tmp_path):
    """A fresh -pm1-ultralowmem run: stage 2 is the 1-register product
    exponent 3^(E * 2p * Q) recomputed from scratch."""
    got = _same(tmp_path, ("jax",), exponent=269, b1=4, b2=2141,
                pm1_variant="ultralowmem")
    assert got[0] % 13822297 == 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume2reg_files_cross(writer, tmp_path):
    """-pm1-s2-resume2reg: one package's stage 1 writes
    resume_p<p>_B1_<b1>.p95 and .save (-resume), the other locates them
    and runs the 2-register stage 2; both files are byte for byte the
    other package's."""
    d = tmp_path / "d"
    d.mkdir()
    kw = dict(exponent=269, b1=4, mode="pm1", save_dir=str(d),
              auto_resume_export=True)
    if writer == "reference":
        japp.run_once(JOptions(backend="numpy", **kw), log=quiet)
    else:
        tapp.run(TOptions(backend="jax", **kw), device="cpu", log=quiet)
    stem = str(d / "resume_p269_B1_4")
    x = pow(3, jprimes.build_e(4) * 2 * 269, (1 << 269) - 1)
    for ext, mod in ((".save", jinterop), (".p95", jinterop)):
        ref = str(tmp_path / ("ref" + ext))
        if ext == ".save":
            mod.write_ecm_resume(ref, 4, 269, x)
        else:
            mod.write_prime95_s1(ref, 269, 4, x)
        with open(ref, "rb") as a, open(stem + ext, "rb") as b:
            assert a.read() == b.read(), ext
    dj, dt = tmp_path / "j", tmp_path / "t"
    for dd in (dj, dt):
        dd.mkdir()
        for ext in (".save", ".p95"):
            shutil.copy(stem + ext, dd)
    s2 = dict(exponent=269, b1=4, b2=2141, mode="pm1",
              pm1_variant="ultralowmem", s2_resume=True)
    rj, jj = japp.run_once(JOptions(backend="numpy", save_dir=str(dj),
                                    **s2), log=quiet)
    rt, jt = tapp.run(TOptions(backend="jax", save_dir=str(dt), **s2),
                      device="cpu", log=quiet)
    assert _outcome(rt, jt) == _outcome(rj, jj)
    assert rt.factor % 13822297 == 0


def test_vtrace_resume_from_reference_checkpoint(tmp_path, monkeypatch,
                                                 m367_resume):
    """The reference's V-trace stage 2 is stopped after four checkpoints;
    the port's resumes from the reference's checkpoint file and finds the
    golden's factor."""
    x = jinterop.read_ecm_resume(m367_resume)[2]
    kw = dict(**M367, mode="pm1", stage2_variant="vtrace",
              backup_interval=0.0, save_dir=str(tmp_path))
    real_write = jpm1.ck.write_checkpoint
    saves = []

    def poisoned_write(path, data):
        real_write(path, data)
        saves.append(path)
        if len(saves) >= 4:
            raise KeyboardInterrupt

    monkeypatch.setattr(jpm1.ck, "write_checkpoint", poisoned_write)
    with pytest.raises(KeyboardInterrupt):
        jpm1.run_pm1_stage2_vtrace(JOptions(backend="numpy", **kw), x,
                                   log=quiet)
    monkeypatch.setattr(jpm1.ck, "write_checkpoint", real_write)
    logs = []
    r = tpm1.run_pm1_stage2_vtrace(TOptions(backend="jax", **kw), x,
                                   log=logs.append, device="cpu")
    assert any("Resuming" in str(ln) for ln in logs)
    assert (r.factor, r.stage) == (M367_S2, 2)


PORT_FOURSTEP = r"""
import json, sys, torch
torch.set_num_threads(1)
from prmers_tpu_torch.io.options import Options
from prmers_tpu_torch.modes import pm1
from prmers_tpu_torch.ops import kernels
made, steps = [], []
real = pm1.create_engine
def create(*a, **k):
    e = real(*a, **k)
    made.append([type(e).__name__, e._chain])
    return e
pm1.create_engine = create
for name in ("square_chain", "square_step", "fwd_step", "mul_step"):
    def wrap(f, name=name):
        def g(*a, **k):
            steps.append(name)
            return f(*a, **k)
        return g
    setattr(kernels, name, wrap(getattr(kernels, name)))
o = Options(exponent=544139, mode="pm1", b1=3, b2=7, backend="pallas",
            save_dir=sys.argv[1])
r = pm1.run_pm1(o, log=lambda *a, **k: None, device="cpu")
print(json.dumps([r.factor, r.stage, r.stage1_factor, r.res64, made,
                  sorted(set(steps))]))
"""


def test_m544139_through_fourstep_plain(tmp_path):
    """p = 544139 (n = 2^15) through FourStepEngine on the CPU: stage 1 on
    K9's plain version, the multiplicands and products of stage 2 on
    K1-K3's; the reference's table row, in a process of its own cut at
    240 s."""
    out = subprocess.run(
        [sys.executable, "-c", PORT_FOURSTEP, str(tmp_path)],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    factor, stage, s1, res64, made, steps = json.loads(
        out.stdout.strip().splitlines()[-1])
    want = _reference((("b1", 3), ("b2", 7), ("exponent", 544139)))
    assert (factor, stage, s1, res64) == want[:4]
    assert (factor, stage, s1) == (22853839, 2, 22853839)
    assert made and all(m == ["FourStepEngine", True] for m in made)
    # K9 for the squarings; K1-K3 for the multiplicands and products
    assert steps == ["fwd_step", "mul_step", "square_chain"]


def test_interop_files_cross(tmp_path):
    """.save (P-1 and ECM lines), .p95 and .mers -> .save written by one
    package load in the other, byte for byte."""
    p, b1 = 541, 899
    x = pow(3, jprimes.build_e(b1) * 2 * p, (1 << p) - 1)
    for name, args in (("write_ecm_resume", (b1, p, x)),
                       ("write_prime95_s1", (p, b1, x)),
                       ("write_ecm_resume_ecm", (b1, p, x, None, 12345)),
                       ("write_ecm_resume_ecm", (b1, p, x, 77, None))):
        a, b = tmp_path / "a", tmp_path / "b"
        getattr(jinterop, name)(str(a), *args)
        getattr(tinterop, name)(str(b), *args)
        assert a.read_bytes() == b.read_bytes(), name
        a.unlink()
        b.unlink()
    path = str(tmp_path / "s.save")
    tinterop.write_ecm_resume(path, b1, p, x)
    assert jinterop.read_ecm_resume(path) == (b1, p, x)
    jinterop.write_prime95_s1(path, p, b1, x)
    assert tinterop.read_prime95_s1(path) == (p, b1, x)
    from prmers_tpu.core.plan import cached_plan
    from prmers_tpu.utils import digits as dgu
    mers = tmp_path / f"{p}pm{b1}.mers"
    dgu.int_to_digits(x, cached_plan(p).widths).astype("<u8").tofile(mers)
    out_j = jinterop.convert_mers_to_save(str(mers), str(tmp_path / "j"))
    out_t = tinterop.convert_mers_to_save(str(mers), str(tmp_path / "t"))
    with open(out_j, "rb") as a, open(out_t, "rb") as b:
        assert a.read() == b.read()
