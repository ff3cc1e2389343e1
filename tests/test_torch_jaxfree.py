"""The port never imports jax nor the JAX package: in a fresh interpreter
(tests/conftest.py imports jax into this one), importing every module of
prmers_tpu_torch (the mesh's parallel/ too) and running one CPU squaring
through the four-step engine and one through the mesh engine leaves
neither jax nor prmers_tpu in sys.modules, and so does one squaring
through the any-size engine, one through the numpy oracle, one through
the XLA-form mesh engine (parallel/sharded.py, with a sharded checkpoint
of parallel/shard_ckpt.py), one through graft_entry.entry and one
through the fft3161 engine (Engine3161 on the CPU; the policy, tune and
profile modules among those imported), a P-1 of
M541 and an Edwards ECM run of M37 on its curve-batched engine (the
modes, host paging, the interop files, the prime sieve, the batched
engine, the web GUI and the validation matrix among the modules
imported). The
machine with the CUDA card has no jax at all, and the port keeps its own
copies of the host modules it needs."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import pkgutil, importlib, sys
import prmers_tpu_torch
for m in pkgutil.walk_packages(prmers_tpu_torch.__path__, "prmers_tpu_torch."):
    if m.name.endswith("__main__"):
        continue
    importlib.import_module(m.name)
from prmers_tpu_torch.core.plan import build_plan
from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine
p, n = 540673, 1 << 15
e = FourStepEngine(p, 2, plan=build_plan(p, n=n), device="cpu")
e.set(0, 3)
e.square_mul(0)
assert e.get_int(0) == 9
from prmers_tpu_torch.parallel.mesh_engine import MeshEngine
m = MeshEngine(p, 2, device="cpu", n=n)
m.set(0, 3)
m.square_mul(0, 3)
assert m.get_int(0) == 27
from prmers_tpu_torch.engine.torch_engine import TorchEngine
from prmers_tpu_torch.engine.np_engine import NumpyEngine
for eng in (TorchEngine(9941, 2, device="cpu"), NumpyEngine(9941, 2)):
    eng.set(0, 3)
    eng.square_mul(0, 3)
    assert eng.get_int(0) == 27
from prmers_tpu_torch.parallel.sharded import ShardedEngine
from prmers_tpu_torch.parallel import shard_ckpt
import tempfile
e = ShardedEngine(9941, 2, device="cpu")
e.set(0, 3)
e.square_mul(0, 3)
ck = tempfile.mkdtemp()
shard_ckpt.save_sharded(e, ck, {"iteration": 1})
e.set(0, 1)
assert shard_ckpt.load_sharded(e, ck) == {"iteration": 1}
assert e.get_int(0) == 27
from prmers_tpu_torch import graft_entry
fn, args = graft_entry.entry(device="cpu")
fn(*args)
from prmers_tpu_torch.engine.engine3161 import Engine3161
e = Engine3161(11213, 2, device="cpu")
e.set(0, 3)
e.square_mul(0, 3)
assert e.get_int(0) == 27
for name in ("modes.pm1", "modes.ecm", "modes.ecm_edwards", "modes.memtest",
             "modes.bench", "engine.paged", "io.interop", "io.p95",
             "utils.primes", "app", "core.field2", "ops.ntt2",
             "engine.engine3161", "engine.policy", "core.tune",
             "core.profile", "engine.batch", "ui.webgui",
             "tools.validation_matrix", "parallel.sharded",
             "parallel.shard_ckpt", "graft_entry"):
    assert "prmers_tpu_torch." + name in sys.modules, name
import tempfile
from prmers_tpu_torch.io.options import Options
from prmers_tpu_torch.modes.ecm_edwards import run_ecm_edwards
from prmers_tpu_torch.modes.pm1 import run_pm1
d = tempfile.mkdtemp()
r = run_pm1(Options(exponent=541, mode="pm1", b1=899, backend="jax",
                    save_dir=d), log=lambda *a, **k: None, device="cpu")
assert r.factor == 4312790327
said = []
r = run_ecm_edwards(Options(exponent=37, mode="ecm", b1=20, b2=400,
                            curves=6, curve_seed=3, save_dir=d),
                    log=lambda *a, **k: said.append(str(a[0])),
                    device="cpu")
assert r.factor == 223
assert "ECM-Edwards batched: 6 curves per dispatch x 1 batches" in said
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
print("JAXMODS", bad)
ref = sorted(k for k in sys.modules
             if k == "prmers_tpu" or k.startswith("prmers_tpu."))
print("REFMODS", ref)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "JAXMODS []" in r.stdout, r.stdout
    assert "REFMODS []" in r.stdout, r.stdout


def _sources():
    """(path, stripped line) of every line of the port and chip_smoke.py."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT,
                                                      "prmers_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    for path in sorted(paths):
        with open(path) as fh:
            for line in fh:
                yield os.path.relpath(path, ROOT), line.strip()


def test_no_jax_import_in_sources():
    for f, s in _sources():
        assert not (s.startswith(("import jax", "from jax"))
                    or "import jax" in s), (f, s)


def test_jax_package_reached_only_through_host():
    """No line of the port, and none of chip_smoke.py, imports prmers_tpu:
    the port keeps its own copies of the host modules (core/, engine/api,
    io/, modes/, utils/)."""
    for f, s in _sources():
        assert not s.startswith(("from prmers_tpu.", "from prmers_tpu ",
                                 "import prmers_tpu.",
                                 "import prmers_tpu ")), (f, s)
        assert s not in ("import prmers_tpu", "from prmers_tpu"), (f, s)
