"""The port's arithmetic policy, tune and profile (engine/policy.py,
core/tune.py, core/profile.py, the factory's arithmetic choice and the
app's "Arithmetic path" line and -tune / -profile) against the JAX
package's on the CPU: decide_arith gives the reference's decision on
every case of tests/test_fft3161.py:130-247 (engine names mapped), the
port never reads the repository's TPU tune file, tune records round
trip, a small run_tune measures both arithmetics, -profile reports, and
with no tune record create_engine routes every exponent as before the
policy."""

import dataclasses
import json
import os

import pytest
import torch

from prmers_tpu.core import app as japp
from prmers_tpu.core import tune as jtune
from prmers_tpu.engine import policy as jpolicy
from prmers_tpu.io import cli as jcli
from prmers_tpu_torch import app as tapp
from prmers_tpu_torch import torchconf
from prmers_tpu_torch.core import tune as ttune
from prmers_tpu_torch.core.plan import cached_plan
from prmers_tpu_torch.engine import factory
from prmers_tpu_torch.engine import policy as tpolicy
from prmers_tpu_torch.engine.fourstep_engine import covers
from prmers_tpu_torch.io import cli as tcli
from prmers_tpu_torch.io.options import Options

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("PRMERS_ARITH", "PRMERS_AUTO_PM1_S1_MAX_RATIO",
       "AEVUM_AUTO_PM1_STAGE1_MAX_RATIO", "AEVUM_AUTO_MAX_RATIO",
       "PRMERS_NO_PALLAS", "PRMERS_BACKEND")
# each side's policy, tune module and gl64 engine names (the XLA engine,
# the kernel engine)
SIDES = {"ref": (jpolicy.decide_arith, jtune, "JaxEngine", "PallasEngine"),
         "port": (tpolicy.decide_arith, ttune, "TorchEngine",
                  "FourStepEngine")}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def on_cpu(monkeypatch):
    real = torchconf.device
    monkeypatch.setattr(torchconf, "device",
                        lambda name=None: real("cpu" if name is None
                                               else name))


# the cases of tests/test_fft3161.py:TestPolicy, each a function of
# (decide, tune, xla engine name, kernel engine name, save dir, env) ->
# decisions; test_on_device_tune_data_decisions reads TPU data: not here

def _ratio_and_defaults(decide, tune, xla, kern, d, env):
    return [decide(136279841, "prp", d, gl64_has_pallas=True)]


def _measured_smaller_wins(decide, tune, xla, kern, d, env):
    p = 756839
    d0 = decide(p, "prp", d, gl64_has_pallas=False)
    tune.record(d0.n_gl64, xla, 100.0, d)
    tune.record(d0.n_3161, "Engine3161", 140.0, d)
    return [d0, decide(p, "prp", d, gl64_has_pallas=False)]


def _unmeasured_never_fft3161(decide, tune, xla, kern, d, env):
    return [decide(p, "prp", d, gl64_has_pallas=False)
            for p in (9941, 756839, 136279841)]


def _threshold_boundary(decide, tune, xla, kern, d, env):
    p = 756839
    d0 = decide(p, "pm1_s1", d, gl64_has_pallas=False)
    tune.record(d0.n_gl64, xla, 100.0, d)
    tune.record(d0.n_3161 * 2, "Engine3161", 80.0, d)
    out = [d0]
    for delta in (-0.001, 0.001):
        env.setenv("PRMERS_AUTO_PM1_S1_MAX_RATIO", str(d0.ratio + delta))
        out.append(decide(p, "pm1_s1", d, gl64_has_pallas=False))
    env.delenv("PRMERS_AUTO_PM1_S1_MAX_RATIO")
    return out


def _aevum_spellings(decide, tune, xla, kern, d, env):
    p = 756839
    d0 = decide(p, "pm1_s1", d, gl64_has_pallas=False)
    tune.record(d0.n_gl64, xla, 100.0, d)
    tune.record(d0.n_3161 * 2, "Engine3161", 80.0, d)
    env.setenv("AEVUM_AUTO_PM1_STAGE1_MAX_RATIO", str(d0.ratio + 0.001))
    out = [d0, decide(p, "pm1_s1", d, gl64_has_pallas=False)]
    env.delenv("AEVUM_AUTO_PM1_STAGE1_MAX_RATIO")
    env.setenv("AEVUM_AUTO_MAX_RATIO", str(d0.ratio - 0.001))
    out.append(decide(p, "pm1_s1", d, gl64_has_pallas=False))
    env.delenv("AEVUM_AUTO_MAX_RATIO")
    return out


def _extrapolated(decide, tune, xla, kern, d, env):
    p = 136279841
    d0 = decide(p, "prp", d, gl64_has_pallas=False)
    tune.record(d0.n_gl64 // 2, xla, 300.0, d)
    tune.record(d0.n_3161 // 2, "Engine3161", 10.0, d)
    out = [d0, decide(p, "prp", d, gl64_has_pallas=False)]
    tune.record(d0.n_3161 // 2, "Engine3161", 2000.0, d)
    return out + [decide(p, "prp", d, gl64_has_pallas=False)]


def _tune_overrides(decide, tune, xla, kern, d, env):
    p = 136279841
    d0 = decide(p, "prp", d)
    tune.record(d0.n_gl64, kern, 100.0, d)
    tune.record(d0.n_3161, "Engine3161", 250.0, d)
    out = [d0, decide(p, "prp", d)]
    tune.record(d0.n_gl64, kern, 500.0, d)
    return out + [decide(p, "prp", d)]


def _env_force(decide, tune, xla, kern, d, env):
    env.setenv("PRMERS_ARITH", "fft3161")
    out = [decide(9941, "prp", d)]
    env.delenv("PRMERS_ARITH")
    return out


def _kernel_donor(decide, tune, xla, kern, d, env):
    """A kernel-engine rate is a donor only where the kernels run."""
    p = 136279841
    d0 = decide(p, "prp", d, gl64_has_pallas=True)
    tune.record(d0.n_gl64 // 2, kern, 900.0, d)
    tune.record(d0.n_3161 // 2, "Engine3161", 100.0, d)
    return [decide(p, "prp", d, gl64_has_pallas=h) for h in (True, False)]


CASES = {
    "ratio_and_defaults": (_ratio_and_defaults, ["gl64"]),
    "measured_smaller_transform_wins": (_measured_smaller_wins,
                                        ["gl64", "fft3161"]),
    "unmeasured_never_picks_fft3161": (_unmeasured_never_fft3161,
                                       ["gl64"] * 3),
    "workload_threshold_boundary": (_threshold_boundary,
                                    ["gl64", "gl64", "fft3161"]),
    "reference_aevum_env_spellings": (_aevum_spellings,
                                      ["gl64", "fft3161", "gl64"]),
    "extrapolated_rates": (_extrapolated, ["gl64", "gl64", "fft3161"]),
    "tune_data_overrides": (_tune_overrides, ["gl64", "fft3161", "gl64"]),
    "env_force": (_env_force, ["fft3161"]),
    "kernel_engine_donor": (_kernel_donor, ["gl64", "fft3161"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decide_arith_matches_reference(case, tmp_path, monkeypatch):
    """The same records (the engine names mapped) and environment give
    the same ArithDecision, field for field, on both sides."""
    fn, arith = CASES[case]
    got = {}
    for side, (decide, tune, xla, kern) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        got[side] = [dataclasses.asdict(x) for x in
                     fn(decide, tune, xla, kern, str(d), monkeypatch)]
    assert got["port"] == got["ref"]
    assert [x["arith"] for x in got["port"]] == arith


def test_port_never_reads_the_tpu_tune_file():
    """The repository root holds the JAX package's prmers_tune.json (TPU
    v5e rates, Engine3161 among them); the port's tune file has another
    name, so with the root as save dir the port reads no record and
    decides gl64 where the reference, on those TPU rates, may not."""
    assert ttune.TUNE_FILE != jtune.TUNE_FILE
    assert os.path.exists(jtune.tune_path(ROOT))
    assert not os.path.exists(ttune.tune_path(ROOT))
    assert ttune.load(ROOT) == {}
    for p in (9941, 216091, 756839, 3021377, 136279841):
        d = tpolicy.decide_arith(p, "prp", ROOT)
        assert d.arith == "gl64" and d.ips_3161 == 0.0, (p, d)


def test_tune_records_round_trip(tmp_path):
    d = str(tmp_path)
    ttune.record(256, "Engine3161", 10.0, d)
    ttune.record(256, "Engine3161", 5.0, d)
    ttune.record(512, "TorchEngine", 20.5, d)
    assert ttune.lookup(256, "Engine3161", d) == 10.0
    assert ttune.lookup(512, "TorchEngine", d) == 20.5
    assert ttune.lookup(512, "Engine3161", d) == 0.0
    with open(os.path.join(d, "prmers_torch_tune.json")) as f:
        assert json.load(f) == {"256": {"Engine3161": 10.0},
                                "512": {"TorchEngine": 20.5}}


def test_small_run_tune(tmp_path):
    """-tune capped at p = 127: both arithmetics measured (the any-size
    engine and Engine3161, n = 8) and recorded under the port's names;
    no card, so no mesh entry."""
    lines = []
    opts = Options(exponent=127, mode="tune", bench_iters=2,
                   save_dir=str(tmp_path))
    res = ttune.run_tune(opts, log=lines.append, device="cpu")
    assert set(res) == {(127, "gl64"), (127, "fft3161")}
    assert all(v > 0 for v in res.values())
    assert set(ttune.load(str(tmp_path))) == {"8"}
    assert set(ttune.load(str(tmp_path))["8"]) == {"TorchEngine",
                                                   "Engine3161"}
    assert [ln.split(" n=")[0] for ln in lines] == [
        "tune: p=127 gl64", "tune: p=127 fft3161"]


def test_profile_report_lines(tmp_path, on_cpu, capsys):
    """-profile wraps the engine and ends the run with the report: the
    engine line, the header and one row per op counted."""
    assert tapp.main(["127", "-ll", "-profile", "-save-dir",
                      str(tmp_path)]) == 0
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("[profile]")]
    assert out[0] == "[profile] engine p=127 n=8 (TorchEngine)"
    assert out[1].split() == ["[profile]", "op", "count", "enq", "ms",
                              "ms/op", "est", "total", "s"]
    rows = {ln.split()[1]: int(ln.split()[2]) for ln in out[2:]}
    assert rows["square_sub2"] == 125 and rows["set_multiplicand"] == 1
    assert "LL-UNSAFE on 2^127 - 1 using ProfiledEngine" in \
        (tmp_path / "prmers.log").read_text()


def test_profiled_engine_delegates():
    """ProfiledEngine counts each op and forwards it, addsub included."""
    from prmers_tpu_torch.core.profile import ProfiledEngine
    from prmers_tpu_torch.engine.torch_engine import TorchEngine
    pe = ProfiledEngine(TorchEngine(127, 4, device="cpu", graphs=False))
    pe.set(0, 5)
    pe.set(1, 3)
    pe.addsub(2, 3, 0, 1)
    pe.square_mul_seq(2, [1, 1])
    assert pe.get_int(2) == 8 ** 4 and pe.get_int(3) == 2
    assert pe.counts["addsub"] == 1 and pe.counts["square_mul"] == 2
    ms = pe.calibrate(reps=1)
    assert set(ms) == {"square_mul"} and ms["square_mul"] > 0


@pytest.mark.parametrize("argv", [["127", "-ll"], ["9941"],
                                  ["756839", "-pm1", "-b1", "100"],
                                  ["9941", "-arith", "fft3161"],
                                  ["9941", "-pfa3"], ["-bench"],
                                  ["127", "-memtest"]])
def test_arith_line_matches_reference(argv, tmp_path):
    """_log_arith_decision logs the reference's line for the same options
    and (no) tune records, and nothing for -bench, -memtest."""
    argv = argv + ["-save-dir", str(tmp_path)]
    lines = {}
    for side, fn, cli in (("ref", japp._log_arith_decision, jcli),
                          ("port", tapp._log_arith_decision, tcli)):
        lines[side] = []
        fn(cli.parse_args(argv), lines[side].append)
    assert lines["port"] == lines["ref"]
    if "-bench" in argv or "-memtest" in argv:
        assert lines["port"] == []
    else:
        assert len(lines["port"]) == 1
        assert lines["port"][0].startswith("Arithmetic path: ")


# the exponents phases 3-9 of chip_smoke.py hand create_engine
SMOKE_P = (136279841, 600000001, 1000000007, 9999991, 756839, 332192831,
           6972593, 700000001, 1600003, 9941, 100003, 127, 2699, 11213,
           541, 367, 544139, 1362763, 29, 37, 1279)


def test_no_tune_record_keeps_every_route(tmp_path, monkeypatch):
    """With no port tune file (in the working directory, where the
    factory's decide_arith reads), "auto" gives the engine it gave before
    the policy: FourStepEngine where fourstep_engine.covers holds, the
    any-size engine elsewhere (the classes stubbed: no tables built)."""
    monkeypatch.chdir(tmp_path)
    made = []
    for name in ("FourStepEngine", "TorchEngine", "TorchRowEngine",
                 "MeshEngine", "Engine3161"):
        monkeypatch.setattr(factory, name,
                            lambda *a, _n=name, **k: made.append(_n) or _n)
    for p in SMOKE_P:
        for wl in ("generic", "prp", "pm1_s1", "ecm"):
            got = factory.create_engine(p, 2, device="cpu", workload=wl)
            want = "FourStepEngine" if covers(cached_plan(p)) else \
                "TorchEngine"
            assert got == want, (p, wl)


def test_tune_record_routes_one_card_to_the_mesh(tmp_path, monkeypatch):
    """A MeshEngine rate more than 2% above FourStepEngine's at the size
    (in the working directory's tune file) sends "auto" to MeshEngine on
    one rank; within 2%, or under PRMERS_NO_MESH_SINGLE, it does not."""
    monkeypatch.chdir(tmp_path)
    made = []
    for name in ("FourStepEngine", "MeshEngine"):
        monkeypatch.setattr(factory, name,
                            lambda *a, _n=name, **k: made.append(_n) or _n)
    n = cached_plan(756839).n
    ttune.record(n, "FourStepEngine", 100.0)
    ttune.record(n, "MeshEngine", 101.0)
    assert factory.create_engine(756839, 2, device="cpu") == \
        "FourStepEngine"
    ttune.record(n, "MeshEngine", 103.0)
    assert factory.create_engine(756839, 2, device="cpu") == "MeshEngine"
    monkeypatch.setenv("PRMERS_NO_MESH_SINGLE", "1")
    assert factory.create_engine(756839, 2, device="cpu") == \
        "FourStepEngine"
