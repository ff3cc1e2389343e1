"""FourStepEngine (prmers_tpu_torch) on the CPU against big-int and the
JAX PallasEngine (Pallas interpret mode, PRMERS_NO_CHAIN=1 so the JAX side
runs the same three-kernel pipeline per step), at n = 2^15.

Covers the Gerbicz-block op sequence of tests/test_pallas_engine.py:44-60,
LL square_sub2_seq steps, the linear ops, copy aliasing, and checkpoints
crossing between the two engines in both directions (spectral
multiplicands included).
"""

import json
import os

import numpy as np
import pytest
import torch

from prmers_tpu.core.plan import build_plan
from prmers_tpu.utils import gmp
from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine

N = 1 << 15
P_EXP = int(N * 16.5) | 1
MP = (1 << P_EXP) - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side,
    and torch's thread pools in each of them would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port():
    return FourStepEngine(P_EXP, 8, plan=build_plan(P_EXP, n=N),
                          device="cpu")


@pytest.fixture(scope="module")
def port():
    return _port()


@pytest.fixture(scope="module")
def jax_eng():
    saved = {k: os.environ.get(k) for k in
             ("PRMERS_PALLAS_INTERPRET", "PRMERS_NO_CHAIN")}
    os.environ["PRMERS_PALLAS_INTERPRET"] = "1"
    os.environ["PRMERS_NO_CHAIN"] = "1"
    from prmers_tpu.engine.pallas_engine import PallasEngine
    e = PallasEngine(P_EXP, 8, plan=build_plan(P_EXP, n=N))
    assert not e._chain and e._rc
    yield e
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_copy_never_aliases(port):
    port.set(0, 3)
    port.copy(3, 0)
    a, b = port.regs[0], port.regs[3]
    ptrs = {a[0].data_ptr(), a[1].data_ptr()}
    assert not ptrs & {b[0].data_ptr(), b[1].data_ptr()}
    port.square_mul(0)
    assert port.get_int(3) == 3 and port.get_int(0) == 9


def test_gerbicz_block_sequence_bigint(port):
    """tests/test_pallas_engine.py:44-60 on the port."""
    B = 24
    e = port
    e.set(0, 3)
    e.set(1, 3)
    e.square_mul_seq(0, [1] * B)
    e.copy(3, 1)
    e.set_multiplicand(2, 0)
    e.mul(1, 2)
    e.square_mul_seq(3, [1] * (B - 1))
    e.square_mul(3, 3)
    assert e.get_int(3) % MP == gmp.powmod(3, (1 << B) + 1, MP)
    assert e.get_int(1) % MP == 3 * gmp.powmod(3, 1 << B, MP) % MP
    e.copy(4, 0)
    e.square_mul(0, 1)
    assert e.get_int(4) % MP == gmp.powmod(3, 1 << B, MP)
    assert e.get_int(0) % MP == gmp.powmod(3, 1 << (B + 1), MP)


def test_linear_ops_and_ll_bigint(port):
    e = port
    e.set(5, 4)
    e.square_sub2_seq(5, 6)
    v = 4
    for _ in range(6):
        v = (v * v - 2) % MP
    assert e.get_int(5) == v
    e.set(6, 12345)
    e.sub(6, 12346)                       # a saturated all-ones ripple
    assert e.get_int(6) == MP - 1
    assert e.digit_equal_to_mp(6) is False
    e.add(6, 5)
    assert e.get_int(6) == (v - 1) % MP
    e.sub_reg(6, 5)
    assert e.get_int(6) == MP - 1
    e.add_small(6, 1)                     # M_p: the all-ones digits
    assert e.get_int(6) == 0 and e.digit_equal_to_mp(6)


def test_matches_pallas_engine(port, jax_eng):
    """The same op mix on both engines: equal values, equal to big-int,
    and multiplicands equal mod P."""
    rng = np.random.default_rng(31)
    v = int.from_bytes(rng.bytes(P_EXP // 8), "little") % MP
    for e in (port, jax_eng):
        e.set(0, 3)
        e.set(1, v)
        e.square_mul_seq(0, [1] * 3)
        e.set_multiplicand(2, 0)
        e.mul(1, 2)
        e.set(5, v)
        e.square_sub2_seq(5, 2)
    x0 = gmp.powmod(3, 8, MP)
    assert port.get_int(0) == jax_eng.get_int(0) == x0
    assert port.get_int(1) == jax_eng.get_int(1) == v * x0 % MP
    ll = v
    for _ in range(2):
        ll = (ll * ll - 2) % MP
    assert port.get_int(5) == jax_eng.get_int(5) == ll
    GP = (1 << 64) - (1 << 32) + 1
    pu, ps = port.get_raw_tagged(2)
    ju, js = jax_eng.get_raw_tagged(2)
    assert ps and js
    assert (pu % np.uint64(GP) == ju % np.uint64(GP)).all()


def test_checkpoints_cross_both_ways(port, jax_eng):
    """port.get_checkpoint -> PallasEngine.set_checkpoint and back: every
    register's value, and a carried multiplicand still multiplies."""
    e = _port()
    rng = np.random.default_rng(37)
    vals = [int.from_bytes(rng.bytes(P_EXP // 8), "little") % MP
            for _ in range(8)]
    for r, v in enumerate(vals):
        e.set(r, v)
    e.square_mul(4)                     # leaves pending row carries
    vals[4] = vals[4] * vals[4] % MP
    e.set_multiplicand(7, 6)            # a spectral register
    jax_eng.set_checkpoint(e.get_checkpoint())
    for r in range(7):
        assert jax_eng.get_int(r) == vals[r], r
    jax_eng.mul(0, 7)
    assert jax_eng.get_int(0) == vals[0] * vals[6] % MP

    jax_eng.set(1, 5)
    jax_eng.set_multiplicand(3, 2)
    f = _port()
    f.set_checkpoint(jax_eng.get_checkpoint())
    assert f.get_int(0) == vals[0] * vals[6] % MP
    assert f.get_int(1) == 5
    assert f.regs[3][2] and f.regs[7][2]
    f.mul(1, 3)
    assert f.get_int(1) == 5 * vals[2] % MP
    f.mul(1, 7)
    assert f.get_int(1) == 5 * vals[2] * vals[6] % MP


def test_factory_raises_on_uncovered_shapes():
    """The four-step engine, and the factory's "pallas" backend, raise on
    a plan check_shape does not take; "auto" routes such a plan to the
    any-size engine instead (engine/torch_engine.py)."""
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.engine.torch_engine import TorchEngine
    with pytest.raises(NotImplementedError):
        create_engine(9941, 2, device="cpu", backend="pallas")  # n < 2^15
    with pytest.raises(NotImplementedError):
        FourStepEngine(P_EXP, 2, plan=build_plan(P_EXP, n=5 << 14),
                       device="cpu")
    assert type(create_engine(9941, 2, device="cpu")) is TorchEngine


def test_cli_refuses_what_is_not_ported(monkeypatch):
    """What this test once saw refused is ported now. -tune: app.run hands
    it to core/tune.run_tune with its device (tests/test_torch_policy.py
    runs a small one). P-1 and ECM (tests/test_torch_pm1.py,
    test_torch_ecm.py): app.run hands them to their drivers, Edwards
    unless -montgomery, with its device."""
    from prmers_tpu.io.cli import parse_args
    from prmers_tpu_torch import app
    seen = []
    monkeypatch.setattr(app, "run_tune", lambda opts, log=print,
                        device=None: seen.append((opts.mode, device)) or {})
    assert app.run(parse_args(["-tune"]), device="cpu") == ({}, "")
    assert seen == [("tune", "cpu")]
    seen = []

    def driver(name):
        def run(opts, log=print, device=None):
            seen.append((name, opts.mode, device))
            raise KeyboardInterrupt
        return run
    for name in ("run_pm1", "run_ecm", "run_ecm_edwards"):
        monkeypatch.setattr(app, name, driver(name))
    for argv in (["-pm1", "-b1", "100"], ["-ecm", "-b1", "100"],
                 ["-ecm", "-b1", "100", "-montgomery"]):
        with pytest.raises(KeyboardInterrupt):
            app.run(parse_args([str(P_EXP), *argv]), device="cpu")
    assert seen == [("run_pm1", "pm1", "cpu"),
                    ("run_ecm_edwards", "ecm", "cpu"),
                    ("run_ecm", "ecm", "cpu")]


@pytest.mark.parametrize("argv,env", [
    (["-arith", "fft3161"], {}),
    (["-pfa3"], {}),
    (["-pfa9"], {}),
    ([], {"PRMERS_ARITH": "fft3161"}),
    (["-profile"], {}),
])
def test_cli_refuses_fft3161_and_profile(argv, env, monkeypatch, tmp_path,
                                        capsys):
    """The second arithmetic and -profile, once refused, are ported: the
    run's engine (create_engine as the app calls it, on the CPU; the
    driver stubbed) is Engine3161 for -arith fft3161, its -pfa3 and -pfa9
    aliases and PRMERS_ARITH=fft3161, and for -profile a ProfiledEngine
    around the kernel engine, whose report ends the run."""
    from prmers_tpu_torch.core.profile import ProfiledEngine
    from prmers_tpu_torch.engine import factory
    from prmers_tpu_torch.engine.engine3161 import Engine3161
    made = []
    app = _stub_run(monkeypatch, made)

    def engine(*a, **k):
        made.append(factory.create_engine(*a, **dict(k, device="cpu")))
        return made[-1]
    monkeypatch.setattr(app, "create_engine", engine)
    monkeypatch.delenv("PRMERS_ARITH", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert app.main([str(P_EXP), "-noproof", "-save-dir", str(tmp_path),
                     *argv]) == 0
    out = capsys.readouterr().out
    (eng,) = made
    if argv == ["-profile"]:
        assert type(eng) is ProfiledEngine
        assert type(eng.inner) is FourStepEngine
        assert f"[profile] engine p={P_EXP} n={N} (FourStepEngine)" in out
    else:
        assert type(eng) is Engine3161
        assert "Arithmetic path: fft3161 (" in out


def _stub_run(monkeypatch, made):
    """app's engine and PRP/LL run replaced: the engine is a marker and
    the run logs one line and returns a prime verdict."""
    from prmers_tpu_torch import app
    from prmers_tpu_torch.modes.prp_ll import PrpLlResult

    def engine(*a, **k):
        made.append(a)
        return object()

    def prp_run(opts, eng=None, proof_set=None, log=print):
        log("run line")
        return PrpLlResult(p=opts.exponent, mode=opts.mode, is_prime=True,
                           res64="0000000000000001", res2048="01",
                           transform_size=N)
    monkeypatch.setattr(app, "create_engine", engine)
    monkeypatch.setattr(app, "run_prp_or_ll", prp_run)
    return app


def test_cli_writes_results_json_and_log(tmp_path, monkeypatch, capsys):
    """-results gets the printed JSON line appended, the save dir gets
    <p>_prp_result.json with the same line, and prmers.log gets the log
    lines (the run's and the JSON), appended run after run
    (prmers_tpu/core/app.py:270-274, :293)."""
    made = []
    app = _stub_run(monkeypatch, made)
    res, d = tmp_path / "R.txt", tmp_path / "D"
    argv = [str(P_EXP), "-noproof", "-results", str(res), "-save-dir",
            str(d)]
    for run in (1, 2):
        assert app.main(argv) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(line)["exponent"] == P_EXP
        assert res.read_text().splitlines() == [line] * run
        assert (d / f"{P_EXP}_prp_result.json").read_text() == line
        log = (d / "prmers.log").read_text().splitlines()
        assert len(log) == 3 * run
        assert "] Arithmetic path: gl64 (" in log[-3]
        assert log[-2].endswith("] run line") and log[-1].endswith(line)
    assert len(made) == 2


@pytest.mark.parametrize("argv", [["-filemers", "m.mers"], ["-gui"]])
def test_cli_refuses_filemers_and_gui(argv, tmp_path, monkeypatch, capsys):
    """-filemers converts and exits (through io/interop.convert_mers_to_save,
    tests/test_torch_modes.py), so a missing .mers file ends the run with
    the reference's "-filemers failed" and exit code 1, and no engine.
    -gui, no longer refused, runs the (stubbed) PRP with the web GUI up on
    its -gui-port: the GUI's line is logged, /api/state answers during the
    run with the exponent, and the server is down after it."""
    import socket
    import urllib.request
    made, states = [], []
    app = _stub_run(monkeypatch, made)
    monkeypatch.chdir(tmp_path)
    argv_all = [str(P_EXP), "-noproof", "-save-dir", str(tmp_path), *argv]
    if argv[0] == "-filemers":
        assert app.main(argv_all) == 1
        assert "-filemers failed" in capsys.readouterr().out
        assert made == []
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}/api/state"
    prp_run = app.run_prp_or_ll

    def run_with_gui(opts, **kw):
        with urllib.request.urlopen(url, timeout=10) as r:
            states.append(json.loads(r.read()))
        return prp_run(opts, **kw)
    monkeypatch.setattr(app, "run_prp_or_ll", run_with_gui)
    assert app.main(argv_all + ["-gui-port", str(port)]) == 0
    assert f"web GUI on http://localhost:{port}" in capsys.readouterr().out
    assert len(made) == 1 and [s["exponent"] for s in states] == [P_EXP]
    with pytest.raises(OSError):
        urllib.request.urlopen(url, timeout=10)


@pytest.mark.parametrize("name,value", [("PRMERS_NO_PALLAS", "1"),
                                        ("PRMERS_SHARDED_IMPL", "xla")])
def test_create_engine_refuses_xla_switches(name, value, monkeypatch):
    """The JAX package's two XLA switches give the port's counterparts:
    PRMERS_NO_PALLAS, the XLA engine in place of the kernel engine, the
    any-size engine; PRMERS_SHARDED_IMPL=xla, once refused, the XLA-form
    mesh engine (parallel/sharded.ShardedEngine) under "sharded", while
    "auto" on one rank keeps the four-step engine; PRMERS_SHARDED_IMPL at
    another value changes nothing."""
    from prmers_tpu_torch.engine.factory import create_engine
    from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine
    from prmers_tpu_torch.engine.torch_engine import TorchEngine
    from prmers_tpu_torch.parallel.sharded import ShardedEngine
    for k in ("PRMERS_NO_PALLAS", "PRMERS_SHARDED_IMPL", "PRMERS_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(name, value)
    if name == "PRMERS_NO_PALLAS":
        assert type(create_engine(756839, 2, device="cpu")) is TorchEngine
    else:
        assert type(create_engine(756839, 2, device="cpu")) is \
            FourStepEngine
        assert type(create_engine(756839, 2, device="cpu",
                                  backend="sharded")) is ShardedEngine
    monkeypatch.setenv("PRMERS_SHARDED_IMPL", "pallas")
    monkeypatch.delenv("PRMERS_NO_PALLAS", raising=False)
    assert create_engine(756839, 2, device="cpu").t.fp.n == 1 << 15


def test_create_engine_takes_arith_and_workload(monkeypatch):
    """The reference's keywords: "auto" and "gl64" (any workload) give
    the default engine; "fft3161", by argument or PRMERS_ARITH, gives
    Engine3161 (engine/engine3161.py); another name raises."""
    from prmers_tpu_torch.engine.factory import create_engine
    monkeypatch.delenv("PRMERS_ARITH", raising=False)
    base = create_engine(756839, 2, device="cpu")
    for kw in ({"arith": "gl64", "workload": "prp"}, {"arith": "auto"},
               {"workload": "ecm"}):
        e = create_engine(756839, 2, device="cpu", **kw)
        assert type(e) is type(base) and e.t.fp.shape == base.t.fp.shape
        assert e.t.fp.pipe == base.t.fp.pipe
    from prmers_tpu_torch.engine.engine3161 import Engine3161
    e = create_engine(756839, 2, device="cpu", arith="fft3161")
    assert type(e) is Engine3161 and e.get_size() == 24576
    with pytest.raises(ValueError):
        create_engine(756839, 2, device="cpu", arith="m31")
    monkeypatch.setenv("PRMERS_ARITH", "fft3161")
    assert type(create_engine(756839, 2, device="cpu")) is Engine3161


def test_default_device_is_cuda():
    """No silent CPU fallback: without a card and without device='cpu'
    the port raises."""
    from prmers_tpu_torch import torchconf
    if torch.cuda.is_available():
        assert torchconf.device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            torchconf.device()
        with pytest.raises(RuntimeError):
            FourStepEngine(P_EXP, 2, plan=build_plan(P_EXP, n=N))
