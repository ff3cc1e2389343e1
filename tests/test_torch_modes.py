"""The port's utility modes and its app (prmers_tpu_torch/modes/memtest.py,
modes/bench.py, app.py) against the JAX package's on the CPU: memtest's
verdicts, the -bench ladder's rows, the dispatch through main and
run_app with the reference's exit codes, the worktodo loop (the result
lines, the per-exponent JSON files, the emptied worktodo file) and
-filemers. The port runs on the CPU: its default device is set to "cpu"
for main, which takes no device."""

import dataclasses
import json
import os

import pytest

from prmers_tpu.core import app as japp
from prmers_tpu.io import cli as jcli
from prmers_tpu.io import interop as jinterop
from prmers_tpu.io.options import Options as JOptions
from prmers_tpu.modes import bench as jbench
from prmers_tpu.modes import memtest as jmemtest
from prmers_tpu.utils import primes as jprimes
from prmers_tpu_torch import app as tapp
from prmers_tpu_torch import torchconf
from prmers_tpu_torch.io.options import Options as TOptions
from prmers_tpu_torch.modes import bench as tbench
from prmers_tpu_torch.modes import memtest as tmemtest


def quiet(*a, **k):
    pass


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's device default is the card; here it is the CPU."""
    real = torchconf.device
    monkeypatch.setattr(torchconf, "device",
                        lambda name=None: real("cpu" if name is None
                                               else name))


def _strip(line: str) -> dict:
    d = json.loads(line)
    d.pop("timestamp")
    d.pop("checksum")
    return d


@pytest.mark.parametrize("backend", ["jax", "numpy"])
def test_memtest_matches_reference(backend):
    kw = dict(exponent=521, mode="memtest", bench_iters=2)
    rj = jmemtest.run_memtest(JOptions(backend="numpy", **kw), log=quiet)
    rt = tmemtest.run_memtest(TOptions(backend=backend, **kw), log=quiet,
                              device="cpu")
    assert (rt.p, rt.passes, rt.errors, rt.roundtrip_errors) == \
        (rj.p, rj.passes, rj.errors, rj.roundtrip_errors) == (521, 2, 0, 0)
    assert rt.ips > 0


def test_bench_ladder_matches_reference(monkeypatch):
    """The -bench ladder over two of its exponents: the same rows
    (exponent, transform length) and a PRMERS_SCORE line."""
    ladder = [127, 9941]
    monkeypatch.setattr(jbench, "BENCH_EXPONENTS", ladder)
    monkeypatch.setattr(tbench, "BENCH_EXPONENTS", ladder)
    o = dict(mode="bench", bench_iters=8)
    rj = jbench.run_bench(JOptions(backend="numpy", **o), log=quiet)
    logs = []
    rt = tbench.run_bench(TOptions(backend="jax", **o), log=logs.append,
                          device="cpu")
    assert [r[:2] for r in rt.rows] == [r[:2] for r in rj.rows] == \
        [(127, 8), (9941, 512)]
    assert rt.score > 0 and any("PRMERS_SCORE" in ln for ln in logs)


@pytest.mark.parametrize("argv,code,line", [
    (["541", "-pm1", "-b1", "899"], 0, True),             # a factor
    (["1277", "-pm1", "-b1", "100", "-b2", "200"], 1, True),  # none
    (["521", "-memtest", "-iters", "1"], 0, False),       # clean
    (["127", "-noproof"], 0, True),                       # prime
    (["1277", "-ll"], 1, True),                           # composite
    ([], 2, False),                                       # nothing to do
])
def test_main_exit_codes(argv, code, line, tmp_path, monkeypatch, on_cpu):
    """main's exit codes are the reference's run_app's, and the result
    line it appends equals the reference's (time stamp aside)."""
    monkeypatch.chdir(tmp_path)
    codes, lines = [], []
    for name, main, extra in (("j", japp.main, ["-backend", "numpy"]),
                              ("t", tapp.main, [])):
        d = tmp_path / name
        full = argv + extra + ["-save-dir", str(d), "-results",
                               str(d / "results.txt"), "-worktodo",
                               str(tmp_path / "none.txt")]
        codes.append(main(full))
        res = d / "results.txt"
        lines.append([_strip(ln) for ln in res.read_text().splitlines()]
                     if res.exists() else [])
    assert codes == [code, code]
    assert lines[0] == lines[1]
    assert len(lines[0]) == int(line)


def test_worktodo_loop(tmp_path, monkeypatch, on_cpu):
    """Two entries (P-1 of M541 from a Pminus1 line, PRP of M521): both
    results appended to -results, both per-exponent JSON files written,
    the worktodo file left empty, exit code 0; the same lines as the
    reference's loop."""
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, main, extra in (("j", japp.main, ["-backend", "numpy"]),
                              ("t", tapp.main, [])):
        d = tmp_path / name
        d.mkdir()
        wt = d / "worktodo.txt"
        wt.write_text("Pminus1=1,2,541,-1,899,0\nPRP=1,2,521,-1\n")
        code = main(["-noproof", "-worktodo", str(wt), "-save-dir", str(d),
                     "-results", str(d / "results.txt"), *extra])
        assert code == 0
        assert wt.read_text().strip() == ""
        lines = (d / "results.txt").read_text().splitlines()
        assert [json.loads(ln)["exponent"] for ln in lines] == [541, 521]
        assert (d / "541_pm1_result.json").read_text() == lines[0]
        assert (d / "521_prp_result.json").read_text() == lines[1]
        out[name] = [_strip(ln) for ln in lines]
    assert out["t"] == out["j"]
    assert out["t"][0]["factors"] == ["4312790327"]
    assert out["t"][1]["status"] == "P"


def test_merge_worktodo_is_the_reference(tmp_path):
    from prmers_tpu.io import worktodo as jwt
    e = jwt.parse_line('Pminus1=1,2,367,-1,11981,38971,70,38000,"7"')
    a = japp._merge_worktodo(JOptions(), e)
    b = tapp._merge_worktodo(TOptions(), e)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_filemers(tmp_path, monkeypatch):
    """-filemers: main converts a <p>pm<B1>.mers checkpoint (raw LE u64
    digits) into the GMP-ECM .save the reference's interop writes for the
    same residue, byte for byte, and exits 0 with no engine."""
    from prmers_tpu.core.plan import cached_plan
    from prmers_tpu.utils import digits as dgu
    monkeypatch.chdir(tmp_path)
    p, b1 = 541, 899
    x = pow(3, jprimes.build_e(b1) * 2 * p, (1 << p) - 1)
    mers = tmp_path / f"{p}pm{b1}.mers"
    dgu.int_to_digits(x, cached_plan(p).widths).astype("<u8").tofile(mers)
    assert tapp.main(["-filemers", str(mers), "-save-dir",
                      str(tmp_path)]) == 0
    want = tmp_path / "want.save"
    jinterop.write_ecm_resume(str(want), b1, p, x)
    assert (tmp_path / f"{p}pm{b1}.save").read_bytes() == want.read_bytes()
    assert os.path.getsize(want) > 100


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_state(port: int) -> dict:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/state",
                                timeout=10) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("argv", [["-tune"], ["127", "-profile"],
                                  ["127", "-gui"],
                                  ["127", "-arith", "fft3161"]])
def test_unported_stop_before_any_engine(argv, tmp_path, monkeypatch,
                                        on_cpu):
    """Flags once stopped here before any engine, now each run: -gui runs
    M127 with the web GUI on a free port, whose /api/state answers during
    the run (asked when the engine is made) with the exponent and the
    Arithmetic path's choice, and is down once the run ends; -tune with
    no exponent goes to core/tune.run_tune (stubbed: the whole ladder is
    the card's work) and makes no engine here; -profile runs M127 on a
    ProfiledEngine; -arith fft3161 runs M127 on Engine3161."""
    from prmers_tpu_torch.core.profile import ProfiledEngine
    from prmers_tpu_torch.engine import factory
    from prmers_tpu_torch.engine.engine3161 import Engine3161
    from prmers_tpu_torch.engine.torch_engine import TorchEngine
    made, tuned, states = [], [], []
    port = _free_port()

    def engine(*a, **k):
        if "-gui" in argv:
            states.append(_get_state(port))
        made.append(factory.create_engine(*a, **k))
        return made[-1]
    monkeypatch.setattr(tapp, "create_engine", engine)
    monkeypatch.setattr(tapp, "run_tune", lambda opts, log=print,
                        device=None: tuned.append(opts.exponent) or {})
    argv = argv + ["-save-dir", str(tmp_path)]
    if "-gui" in argv:
        assert tapp.main(argv + ["-gui-port", str(port)]) == 0
        assert [type(e) for e in made] == [TorchEngine]
        assert len(states) == 1 and states[0]["exponent"] == 127
        assert states[0]["backend"] == "gl64"
        assert states[0]["transform_size"] == 8
        with pytest.raises(OSError):
            _get_state(port)
        return
    assert tapp.main(argv) == 0
    want = {"-tune": [], "-profile": [ProfiledEngine],
            "fft3161": [Engine3161]}[argv[-3]]
    assert [type(e) for e in made] == want
    assert tuned == ([0] if argv[0] == "-tune" else [])


def test_cli_parse_of_modes_equal():
    for argv in (["541", "-pm1", "-b1", "899", "-b2", "5000",
                  "-pm1-ultralowmem"],
                 ["29", "-ecm", "-b1", "300", "-K", "3", "-montgomery"],
                 ["-bench", "-iters", "8"], ["521", "-memtest"],
                 ["-filemers", "541pm899.mers"]):
        from prmers_tpu_torch.io import cli as tcli
        assert dataclasses.asdict(jcli.parse_args(argv)) == \
            dataclasses.asdict(tcli.parse_args(argv))
