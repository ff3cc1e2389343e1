"""The port's device-validation tools (prmers_tpu_torch/tools/: gl_smoke,
device_golden, ab_ladder, settle_probe, lanecarry_check) on the CPU,
each held against the JAX package: the GL window ladder's rows against
the JAX tools/gl_smoke.py loaded by path; the PRP/LL paths the golden
ladder runs (error injection, Wagstaff, an interrupted then resumed run,
-b1old) against tests/test_prp_ll.py and test_interop.py's runs on the
JAX engines; the golden ladder's kill/resume step in subprocesses under
PRMERS_PLATFORM=cpu; the A/B ladder's refusals and one child at a 2^15
plan; the settle probe's cases at n = 2^12 against the JAX carry_full
under jax.jit and carry_full_np; the lane-carry check at a forced T = 2
plan against big-int.

Tolerance: none. Residues, log lines, factors and digits compare
exactly.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prmers_tpu.core.field import FieldOps
from prmers_tpu.engine.factory import create_engine as jax_create_engine
from prmers_tpu.io.options import Options as JOptions
from prmers_tpu.modes.pm1 import run_pm1 as jax_run_pm1
from prmers_tpu.modes.prp_ll import run_prp_or_ll as jax_run_prp
from prmers_tpu.ops import carry as jax_carry
from prmers_tpu_torch.engine.factory import create_engine
from prmers_tpu_torch.io.options import Options
from prmers_tpu_torch.modes.pm1 import run_pm1
from prmers_tpu_torch.modes.prp_ll import run_prp_or_ll
from prmers_tpu_torch.ops import carry as tcarry
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.tools import ab_ladder, device_golden, gl_smoke
from prmers_tpu_torch.tools import lanecarry_check, settle_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_gl_smoke():
    spec = importlib.util.spec_from_file_location(
        "jax_gl_smoke", os.path.join(ROOT, "tools", "gl_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _opts(cls, p, tmp_path, **kw):
    """tests/test_prp_ll.py's opts_for, for either package's Options."""
    o = cls(exponent=p, save_dir=str(tmp_path), proof=False, verbose=False,
            backup_interval=1e9)
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def _port_prp(o, **kw):
    eng = create_engine(o.exponent, 8, device="cpu", workload="prp")
    return run_prp_or_ll(o, eng=eng, **kw)


@pytest.mark.parametrize("p", [127, 761, 1279])
def test_smoke_one_matches_jax(p, tmp_path, monkeypatch):
    """The same ok and the same first "Check passed! iter=" line."""
    monkeypatch.chdir(tmp_path)   # no tune records on either side
    want = _jax_gl_smoke().smoke_one(p)
    got = gl_smoke.smoke_one(p, device="cpu")
    assert got[0] == want[0] is True
    assert got[2] == want[2]
    assert got[2].startswith("[Gerbicz Li] Check passed! iter=")


def test_gl_ladder_rows(monkeypatch, capsys):
    """main: a fresh directory with no records, both arithmetics below
    3021377, one JSON line."""
    import json
    monkeypatch.setenv("PRMERS_PLATFORM", "cpu")
    assert gl_smoke.main(["761"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("tune records in ") and out[0].endswith("none")
    j = json.loads(out[-1])
    assert j["ok"] and j["records"] == [] and j["card"] == "cpu"
    assert [(r["p"], r["arith"], r["engine"]) for r in j["rows"]] == [
        (127, "gl64", "TorchEngine"), (127, "fft3161", "Engine3161"),
        (761, "gl64", "TorchEngine"), (761, "fft3161", "Engine3161")]
    for r in j["rows"]:
        assert r["iter"] > 0 and r["window_s"] > 0 and r["ips"] > 0
    assert "fft3161 unmeasured" in j["rows"][0]["reason"]


def test_error_injection_matches_jax(tmp_path):
    """tests/test_prp_ll.py:55-66 on both engines: the same error count,
    res64 and log lines."""
    logs = {}
    res = {}
    for side, cls, run in (("jax", JOptions, jax_run_prp),
                           ("port", Options, _port_prp)):
        d = tmp_path / side
        d.mkdir()
        msgs = []
        res[side] = run(_opts(cls, 1279, d, mode="prp", erroriter=55,
                              checklevel=1),
                        log=lambda *a, msgs=msgs: msgs.append(
                            " ".join(map(str, a))))
        logs[side] = [m for m in msgs if "Injected error" in m
                      or "Check FAILED" in m or "Restore iter=" in m]
    assert res["port"].is_prime and res["port"].gerbicz_errors >= 1
    assert res["port"].gerbicz_errors == res["jax"].gerbicz_errors
    assert res["port"].res64 == res["jax"].res64 == "0000000000000001"
    assert len(logs["port"]) == 3 and logs["port"] == logs["jax"]


@pytest.mark.parametrize("p,prp", [(122, True), (134, False)])
def test_wagstaff_matches_jax(p, prp, tmp_path):
    """tests/test_prp_ll.py:94-104: q = 61 a Wagstaff prime, 67 not."""
    want = jax_run_prp(_opts(JOptions, p, tmp_path, mode="prp",
                             wagstaff=True), log=lambda *a: None)
    got = _port_prp(_opts(Options, p, tmp_path, mode="prp", wagstaff=True),
                    log=lambda *a: None)
    assert got.wagstaff_prp is want.wagstaff_prp is prp
    assert got.res64 == want.res64


def _interrupt_then_resume(make, run, cls, tmp_path):
    """tests/test_prp_ll.py:68-91: M521 stopped after 5 chunks, then a
    fresh engine resumes from its checkpoint."""
    eng = make()
    orig = eng.square_mul_seq
    calls = {"n": 0}

    def hook(src, a_vec):
        if calls["n"] >= 5:
            raise KeyboardInterrupt
        calls["n"] += 1
        return orig(src, a_vec)

    eng.square_mul_seq = hook
    r1 = run(_opts(cls, 521, tmp_path, mode="prp", backup_interval=0.0),
             eng=eng, log=lambda *a: None)
    msgs = []
    r2 = run(_opts(cls, 521, tmp_path, mode="prp"), eng=make(),
             log=lambda *a: msgs.append(" ".join(map(str, a))))
    return r1, r2, msgs


def test_interrupt_resume_matches_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    j1, j2, jmsgs = _interrupt_then_resume(
        lambda: jax_create_engine(521, 8, backend="jax"), jax_run_prp,
        JOptions, tmp_path / "jax")
    p1, p2, pmsgs = _interrupt_then_resume(
        lambda: create_engine(521, 8, device="cpu", workload="prp"),
        run_prp_or_ll, Options, tmp_path / "port")
    assert p1.interrupted and 0 < p1.iteration < 521
    assert p1.iteration == j1.iteration
    assert any("Resuming" in m for m in pmsgs)
    assert any("Resuming" in m for m in jmsgs)
    assert p2.is_prime and p2.res64 == j2.res64 == "0000000000000001"


def test_golden_kill_resume_cpu(monkeypatch):
    """The golden ladder's kill/resume step in subprocesses on the CPU:
    killed at its first checkpoint, resumed to res64 1."""
    monkeypatch.setenv("PRMERS_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    detail = device_golden.kill_resume(CPU, p=2203, backup_s=0.2)
    assert detail.startswith("killed_midrun=True, resumed=True")
    assert detail.endswith("[TorchEngine]")


def test_golden_record_under_build(tmp_path, monkeypatch):
    """The record goes to build/device_golden/, never to the root."""
    monkeypatch.setattr(device_golden, "REPO", str(tmp_path))
    out = {"device": "cpu", "timestamp": "t", "passed": 1, "total": 1,
           "steps": [{"step": "s", "ok": True, "secs": 0.1,
                      "detail": "d"}]}
    path = device_golden.write_record(out, "r04")
    assert path == str(tmp_path / "build" / "device_golden" / "DEVICE_r04.md")
    assert sorted(os.listdir(tmp_path)) == ["build"]
    assert "| s | PASS | 0.1s | d |" in open(path).read()


def test_b1old_matches_jax(tmp_path):
    """tests/test_interop.py:99-113 on the port's any-size engine: B1 300
    leaves its resume file, -b1old 300 extends it to 899 and finds the
    factor, as the JAX package does on numpy."""
    res = {}
    for side, cls, run, kw in (
            ("jax", JOptions, jax_run_pm1, {"backend": "numpy"}),
            ("port", Options, run_pm1, {"backend": "jax"})):
        d = tmp_path / side
        d.mkdir()
        path = str(d / "resume_p541_B1_300.save")
        o1 = cls(exponent=541, mode="pm1", b1=300, resume_save=path,
                 save_dir=str(d), **kw)
        o2 = cls(exponent=541, mode="pm1", b1=899, b1_old=300,
                 save_dir=str(d), **kw)
        extra = {} if side == "jax" else {"device": "cpu"}
        r1 = run(o1, log=lambda *a: None, **extra)
        r2 = run(o2, log=lambda *a: None, **extra)
        res[side] = (r1.factor, r1.res64, r2.factor,
                     open(path).read())
    assert res["port"] == res["jax"]
    assert res["port"][0] == 0 and res["port"][2] == 4312790327


def test_ab_rejects_unread_switch(monkeypatch):
    """PRMERS_BYTECAST (a TPU switch) is rejected before any child."""
    def no_child(*a, **k):
        raise AssertionError("a child started")
    monkeypatch.setattr(ab_ladder, "run_combo", no_child)
    with pytest.raises(ValueError, match="PRMERS_BYTECAST"):
        ab_ladder.ladder(756839, ["", "PRMERS_BYTECAST=0"])
    known = ab_ladder.port_switches()
    for name in ("PRMERS_NO_ROWCARRY", "PRMERS_XLA_CARRY", "PRMERS_NO_CHAIN",
                 "PRMERS_NO_PALLAS", "PRMERS_ARITH", "PRMERS_BACKEND",
                 "PRMERS_NO_MXU"):
        assert name in known
    assert "PRMERS_LHS_BITCAST" not in known


def test_ab_children_cpu(monkeypatch):
    """One child at a 2^15 plan (4 squarings of 3), the one-rank mesh
    child giving the same residue, and PRMERS_NO_MXU reported refused."""
    for k, v in (("PRMERS_PLATFORM", "cpu"), ("AB_K", "2"),
                 ("AB_ITERS", "2"), ("OMP_NUM_THREADS", "1")):
        monkeypatch.setenv(k, v)
    rows = ab_ladder.ladder(540673, ["", "PRMERS_BACKEND=sharded",
                                     "PRMERS_NO_MXU=1"])
    mp = (1 << 540673) - 1
    want = f"{pow(3, 1 << 4, mp) & (2**64 - 1):016X}"
    assert [(r["engine"], r["res64"]) for r in rows[:2]] == [
        ("FourStepEngine", want), ("MeshEngine", want)]
    assert rows[0]["ips"] > 0 and rows[1]["ips"] > 0
    assert rows[2]["ips"] is None
    assert rows[2]["engine"].startswith("REFUSED: NotImplementedError: "
                                        "PRMERS_NO_MXU")
    assert ab_ladder.ladder_ok(rows)


def test_ab_mesh_check_cpu():
    """--mesh at 2^15: the one-rank MeshEngine equals FourStepEngine and
    big-int."""
    r = ab_ladder.mesh_check(15, 2, CPU)
    assert r["bitexact"] and r["n"] == 1 << 15
    assert r["mesh_ips"] > 0 and r["single_ips"] > 0


@pytest.mark.parametrize("case", settle_probe.CASES)
def test_settle_cases_match_jax(case):
    """Each case at n = 2^12: carry_full with the loop and with static
    rounds equals the JAX carry_full under jax.jit and carry_full_np; the
    probe's rows agree, and the static form with the loop's round count
    gives the loop's digits."""
    import types
    y, widths = settle_probe.case_input(case, 1 << 12)
    F = FieldOps(jnp)
    jit = jax.jit(lambda y, w: jax_carry.carry_full(F, y, w, None, 1,
                                                    lax=jax.lax))
    want_jax = np.asarray(jit(jnp.asarray(y), jnp.asarray(widths)))
    want_np = tcarry.carry_full_np(types.SimpleNamespace(xp=np), y, widths,
                                   None)
    assert np.array_equal(want_jax, want_np)
    assert np.array_equal(settle_probe.expected(case, y, widths), want_np)
    yt = tgl.from_numpy_u64(y, CPU)
    wt = torch.from_numpy(widths.astype(np.int64))
    rounds = settle_probe.loop_rounds(yt, wt)
    static = tcarry.absorb_rounds(int(y.max()) + 1, int(widths.min()))
    for r in (None, static, rounds):
        got = tgl.to_numpy_u64(tcarry.carry_full(yt, wt, rounds=r))
        assert np.array_equal(got, want_np), r
    rows = settle_probe.probe(case, CPU, n=1 << 12, reps=1)
    assert [(r["form"], r["rounds"], r["equal"]) for r in rows] == [
        ("loop", rounds, True), ("static", static, True)]


def test_lanecarry_forced_t2():
    """The lane-carry check at n = 2^16 with T = 2 forced (carry budget
    32768): the row carry and the hybrid equal big-int in every case."""
    n = 1 << 16
    p = int(n * 16.3) | 1
    pipes = {"lanecarry": tfs.Pipeline(carry_max=32768),
             "hybrid": tfs.Pipeline(carry_max=32768, xla_carry=True)}
    out = lanecarry_check.run(p, n, CPU, pipes, iters=1)
    assert out["lanecarry"]["carry_tiles"] == 2
    assert out["lanecarry"]["rowcarry"] and not out["lanecarry"]["xla_carry"]
    assert out["hybrid"]["xla_carry"] and not out["hybrid"]["rowcarry"]
    for name in pipes:
        assert out[name]["bitexact"], out[name]["cases"]
        assert set(out[name]["cases"]) == {"chain", "wrap", "roundtrip",
                                           "sq_small", "seq_dense"}
        assert len(out[name]["turns"]) == 2
