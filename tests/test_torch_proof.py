"""PRP proofs (the port's core/proof.py and app.run) and the LL-safe modes
(modes/llsafe.py) on the any-size engine, on the CPU, against the JAX
package: a port proof verifies under the reference's Proof.verify and the
reference's under the port's, the files are byte for byte the same, the
M9941 golden hashes (tests/test_proof.py:13-17), the result JSON's proof
fields, sharded proof residues (PRMERS_PROOF_SHARDED=1: one rank, and
M9941 on 2 gloo ranks under --run-slow), and the LL-safe verdicts of
tests/test_llsafe_cofactor.py."""

import hashlib
import json
import os

import pytest
import torch

from prmers_tpu.core import proof as jproof
from prmers_tpu.core.plan import cached_plan as jcached_plan
from prmers_tpu.engine.np_engine import NumpyEngine as JNumpyEngine
from prmers_tpu.io.options import Options as JOptions
from prmers_tpu.modes import llsafe as jllsafe
from prmers_tpu.modes.prp_ll import run_prp_or_ll as jrun
from prmers_tpu_torch import app
from prmers_tpu_torch.core import proof as tproof
from prmers_tpu_torch.engine.torch_engine import TorchEngine
from prmers_tpu_torch.io.cli import parse_args
from prmers_tpu_torch.io.options import Options
from prmers_tpu_torch.modes import llsafe
from prmers_tpu_torch.modes.prp_ll import run_prp_or_ll

GOLDEN_9941 = [
    "proof [0] : M 87f3d3eabe4d6049, h 4526397be82cea45",
    "proof [1] : M d6a355de518574d7, h 7faf92dd48dc2013",
    "proof [2] : M 5aac235405ca84c7, h 934611f5f1192dd0",
]


def quiet(*a, **k):
    pass


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_best_power_and_points():
    """tests/test_proof.py:19-35 on the port's copy, and the same points
    as the reference's."""
    assert tproof.best_power(9941) == 3
    assert tproof.best_power(60_000_000) == 10
    assert tproof.best_power(240_000_000) == 11
    assert tproof.best_power(127) == 2
    E, power = 9941, 3
    pts = tproof.proof_points(E, power)
    assert len(pts) == 1 << power and pts[-1] == E
    assert all(tproof.is_in_points(E, power, pt) for pt in pts)
    assert not tproof.is_in_points(E, power, 1234)
    for E, power in ((1279, 2), (756839, 6), (136279841, 10)):
        assert tproof.proof_points(E, power) == jproof.proof_points(E, power)


def _port_proof(p, power, d):
    ps = tproof.ProofSet(p, power, widths=jcached_plan(p).widths,
                         save_dir=str(d))
    o = Options(exponent=p, mode="prp", verbose=False, save_dir=str(d),
                backup_interval=1e9)
    r = run_prp_or_ll(o, eng=TorchEngine(p, 8, device="cpu"), proof_set=ps,
                      log=quiet)
    lines = []
    return r, ps.compute_proof(log=lines.append), lines


def _ref_proof(p, power, d):
    ps = jproof.ProofSet(p, power, widths=jcached_plan(p).widths,
                         save_dir=str(d))
    o = JOptions(exponent=p, mode="prp", verbose=False, save_dir=str(d),
                 backup_interval=1e9)
    jrun(o, eng=JNumpyEngine(p, 8), proof_set=ps, log=quiet)
    lines = []
    return ps.compute_proof(log=lines.append), lines


def test_proofs_cross_verify(tmp_path):
    """M1279 at power 2: the port's proof (TorchEngine) verifies under the
    reference's Proof.load(...).verify, the reference's (NumpyEngine) under
    the port's, and the two files are the same bytes; a tampered one
    fails under both."""
    p = 1279
    r, ours, lines = _port_proof(p, 2, tmp_path / "t")
    assert r.is_prime
    ref, ref_lines = _ref_proof(p, 2, tmp_path / "j")
    assert lines == ref_lines
    a = ours.save(str(tmp_path / "t.proof"))
    b = ref.save(str(tmp_path / "j.proof"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert jproof.Proof.load(a).verify(log=quiet)
    assert tproof.Proof.load(b).verify(log=quiet)
    for mod in (tproof, jproof):
        bad = mod.Proof(E=ours.E, B=ours.B ^ 4, middles=ours.middles)
        assert not bad.verify(log=quiet)


@pytest.mark.slow
def test_m9941_proof_hashes(tmp_path):
    """The golden hashes of tests/test_proof.py:13-17 through the port's
    engine (slow as the reference marks it: ~1 min on the CPU; the smoke
    checks them on the card every run)."""
    r, proof, lines = _port_proof(9941, 3, tmp_path)
    assert r.is_prime and lines == GOLDEN_9941
    path = proof.save(str(tmp_path / "m.proof"))
    assert jproof.Proof.load(path).verify(log=quiet)


def test_app_writes_the_proof(tmp_path, monkeypatch):
    """app.run on a PRP of p > 128 writes m<p>-<power>.proof, logs the
    hashes, verifies it under -proofverify and puts its power and md5 in
    the result JSON (prmers_tpu/core/app.py:96-136)."""
    monkeypatch.delenv("PRMERS_PROOF_SHARDED", raising=False)
    d = tmp_path / "run"
    logs = []
    r, j = app.run(parse_args(["1279", "-proofverify", "-save-dir", str(d),
                               "-backend", "jax"]), device="cpu",
                   log=lambda *a: logs.append(" ".join(map(str, a))))
    assert r.is_prime
    path = d / "m1279-2.proof"
    doc = json.loads(j)
    assert doc["proof"]["power"] == 2
    assert doc["proof"]["md5"] == hashlib.md5(path.read_bytes()).hexdigest()
    assert jproof.Proof.load(str(path)).verify(log=quiet)
    assert sum(line.startswith("proof [") for line in logs) == 2
    assert "Verification result: SUCCESS" in logs
    _, j = app.run(parse_args(["1279", "-noproof", "-save-dir", str(d),
                               "-backend", "jax"]), device="cpu", log=quiet)
    assert "proof" not in json.loads(j)


def test_proof_sharded_raises(tmp_path, monkeypatch):
    """PRMERS_PROOF_SHARDED=1, once refused, now writes each residue as
    per-rank digit shards (core/proof.py:164-176; TorchEngine's slab is one
    range): no packed residue file, a committed shard manifest at every
    point, and the same proof bytes and hashes as the packed run."""
    monkeypatch.delenv("PRMERS_PROOF_SHARDED", raising=False)
    runs = {}
    for tag in ("packed", "sharded"):
        if tag == "sharded":
            monkeypatch.setenv("PRMERS_PROOF_SHARDED", "1")
        d = tmp_path / tag
        logs = []
        r, j = app.run(parse_args(["1279", "-save-dir", str(d), "-backend",
                                   "jax"]), device="cpu",
                       log=lambda *a: logs.append(" ".join(map(str, a))))
        assert r.is_prime
        runs[tag] = (d, [x for x in logs if x.startswith("proof [")],
                     (d / "m1279-2.proof").read_bytes())
    d = runs["sharded"][0] / "1279" / "proof"
    names = sorted(os.listdir(d))
    assert names and all(x.endswith(".shards") for x in names)
    for x in names:
        assert os.path.exists(d / x / "manifest.json")
        assert os.path.exists(d / x / "shard_0.bin")
    assert runs["sharded"][1:] == runs["packed"][1:]


def test_sharded_residue_written_on_one_rank(tmp_path):
    """The shard writer on one rank (no group): its two barriers take the
    JAX package's tags (dist.barrier(tag)), the manifest commits, and
    load gives the value back; the JAX package's ProofSet reads the port's
    store."""
    e = TorchEngine(1279, 1, device="cpu")
    v = 0x1234567890ABCDEF << 600
    e.set(0, v)
    ps = tproof.ProofSet(1279, 2, widths=e.widths, save_dir=str(tmp_path))
    it = ps.points[1]
    ps._write_shards(it, [(0, e.get_digits(0))])
    assert not os.path.exists(ps._file(it))
    assert ps.load(it) == v and ps.is_complete() is False
    js = jproof.ProofSet(1279, 2, widths=jcached_plan(1279).widths,
                         save_dir=str(tmp_path))
    assert js.load(it) == v


@pytest.mark.slow
def test_sharded_proof_m9941_two_ranks(tmp_path):
    """M9941 through the CLI under -backend sharded with
    PRMERS_PROOF_SHARDED=1 on 2 gloo ranks (the XLA-form ShardedEngine: n =
    512 is below the four-step engine): prime, each residue as two rank
    shards, and the golden hashes of tests/test_proof.py:13-17 (slow, as
    the reference marks its M9941 proof: ~2 min of 9941 squarings with ten
    collectives each)."""
    from test_torch_mesh import _ranks
    d = tmp_path / "run"
    res = _ranks(tmp_path, "cli", 2,
                 argv=["9941", "-save-dir", str(d), "-backend", "sharded"],
                 env={"PRMERS_PROOF_SHARDED": "1"})
    lines = res[0]["log"]
    assert any("using ShardedEngine" in x for x in lines)
    assert [x for x in lines if x.startswith("proof [")] == GOLDEN_9941
    assert '"status":"P"' in res[0]["json"]
    shards = [x for x in os.listdir(d / "9941" / "proof")]
    assert shards and all(
        sorted(os.listdir(d / "9941" / "proof" / x)) ==
        ["manifest.json", "shard_0.bin", "shard_1.bin"] for x in shards)


def test_proof_written_by_rank_zero_only(tmp_path, monkeypatch):
    """Every rank calls checkpoint_engine (get_digits is the mesh's
    gather); only rank 0 writes the residue file."""
    from prmers_tpu_torch.parallel import dist
    monkeypatch.delenv("PRMERS_PROOF_SHARDED", raising=False)
    e = TorchEngine(1279, 1, device="cpu")
    e.set(0, 12345)
    ps = tproof.ProofSet(1279, 2, widths=e.widths, save_dir=str(tmp_path))
    it = ps.points[1]
    monkeypatch.setattr(dist, "rank", lambda: 1)
    ps.checkpoint_engine(e, it, 0)
    assert not os.path.exists(ps._file(it))
    monkeypatch.setattr(dist, "rank", lambda: 0)
    ps.checkpoint_engine(e, it, 0)
    assert ps.load(it) == 12345


# ---------------------------------------------------------------------------
# LL-safe, LL and the cofactor PRP on the any-size engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,want", [(127, True), (521, True), (11, False)])
def test_llsafe_matches_reference(p, want):
    """run_llsafe (checklevel 2) and run_llsafe2 on TorchEngine against the
    reference's on its NumpyEngine (tests/test_llsafe_cofactor.py:19-32,
    :60-65): the same verdict, residue and error count."""
    for mode, ours, ref, regs in (
            ("llsafe", llsafe.run_llsafe, jllsafe.run_llsafe,
             llsafe.LLSAFE_REGS),
            ("llsafe2", llsafe.run_llsafe2, jllsafe.run_llsafe2,
             llsafe.LLSAFE2_REGS)):
        o = Options(exponent=p, mode=mode, checklevel=2, verbose=False)
        eng = TorchEngine(p, regs, device="cpu") if p >= 127 else None
        a = ours(o, eng=eng, log=quiet)
        jo = JOptions(exponent=p, mode=mode, checklevel=2, verbose=False)
        b = ref(jo, eng=JNumpyEngine(p, regs) if p >= 127 else None,
                log=quiet)
        assert a.is_prime == b.is_prime == want, mode
        assert (a.res64, a.gerbicz_errors) == (b.res64, b.gerbicz_errors)


def test_llsafe2_error_injection_recovers():
    """tests/test_llsafe_cofactor.py:72-84 on the any-size engine."""
    logs = []
    o = Options(exponent=127, mode="llsafe2", erroriter=40, llsafe_block=16)
    r = llsafe.run_llsafe2(o, eng=TorchEngine(127, 8, device="cpu"),
                           log=logs.append)
    joined = "\n".join(str(x) for x in logs)
    assert r.is_prime and r.gerbicz_errors >= 1
    assert "Injected error" in joined and "Check FAILED" in joined


def test_cli_llsafe(tmp_path):
    """app.run dispatches -llsafe and -llsafe2 (prmers_tpu/core/app.py:
    139-150): an LL result line with the verdict."""
    for flag in ("-llsafe", "-llsafe2"):
        r, j = app.run(parse_args(["127", flag, "-save-dir", str(tmp_path),
                                   "-backend", "jax"]), device="cpu",
                       log=quiet)
        doc = json.loads(j)
        assert r.is_prime and doc["worktype"] == "LL" and \
            doc["status"] == "P"


def test_ll_m127_and_m2699_cofactor(tmp_path):
    """M127 LL, and M2699 with 4 of its 5 known factors (composite
    cofactor; tests/test_llsafe_cofactor.py:35-43), through
    run_prp_or_ll on the any-size engine."""
    o = Options(exponent=127, mode="ll", verbose=False, proof=False,
                save_dir=str(tmp_path))
    assert run_prp_or_ll(o, eng=TorchEngine(127, 8, device="cpu"),
                         log=quiet).is_prime
    f4 = ("5399", "307687", "1187561", "7570504839257")
    o = Options(exponent=2699, mode="prp", known_factors=f4, verbose=False,
                proof=False, save_dir=str(tmp_path))
    r = run_prp_or_ll(o, eng=TorchEngine(2699, 8, device="cpu"), log=quiet)
    assert r.cofactor_prp is False
