"""Sharded checkpoints of the port (parallel/shard_ckpt.py) on the CPU:
per-rank shard files and a manifest, loads independent of the rank count,
and stores that cross between the port and the JAX package both ways.

The ranks are gloo processes of tests/torch_mesh_worker.py, as in
tests/test_torch_mesh.py; the JAX side is the reference's ShardedEngine on
conftest's 8-device CPU mesh (mesh8), as tests/test_shard_ckpt.py runs it,
a few ops each. The rejections mirror tests/test_shard_ckpt.py:32-100 and
the 1 -> 2 -> 1 Gerbicz-Li window tests/test_multihost.py:135-192, its two
processes joined through the JAX package's PRMERS_COORDINATOR variables.
Values are checked against big-int; no tolerance."""

import json
import os

import pytest
import torch

from prmers_tpu.parallel import shard_ckpt as jck
from prmers_tpu_torch.engine.torch_engine import TorchEngine
from prmers_tpu_torch.parallel import shard_ckpt
from prmers_tpu_torch.parallel.mesh_engine import MeshEngine
from prmers_tpu_torch.parallel.sharded import ShardedEngine
from test_torch_mesh import _ranks

P1279 = 1279
MP = (1 << P1279) - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_engine(s, regs=3):
    from prmers_tpu.parallel.sharded import ShardedEngine as JShardedEngine
    from prmers_tpu.parallel.sharded import make_mesh
    return JShardedEngine(P1279, regs, make_mesh(s))


def test_roundtrip_same_ranks(tmp_path):
    """2 ranks save three registers (one spectral), clobber them, load:
    the values come back, the manifest flags the multiplicand, and the
    restored multiplicand still multiplies."""
    d = str(tmp_path / "ck")
    meta = {"iteration": 41, "elapsed": 1.5}
    res = _ranks(tmp_path, "engine", 2, engine="sharded", p=P1279, regs=3,
                 ops=[["set", 0, 0x5EED], ["square_mul", 0, 1],
                      ["set", 1, 77], ["set_multiplicand", 2, 1],
                      ["save", d, meta], ["set", 0, 1], ["set", 1, 1],
                      ["set", 2, 1], ["load", d], ["int", 0], ["int", 1],
                      ["mul", 0, 2], ["int", 0]])
    x = 0x5EED * 0x5EED % MP
    for r in res:
        assert r["out"] == [meta, x, 77, x * 77 % MP]
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert man["spectral"] == {"0": False, "1": False, "2": True}
    assert sorted(man["files"]) == ["shard_0.bin", "shard_1.bin"]


def test_repartition_4_to_2(tmp_path):
    """A store of 4 ranks loads into 2, which go on and save their own;
    that loads into one rank (no group)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _ranks(tmp_path, "engine", 4, engine="sharded", p=P1279, regs=2,
           ops=[["set", 0, 1234567], ["square_mul", 0, 1],
                ["save", a, {"iteration": 1}]])
    res = _ranks(tmp_path, "engine", 2, engine="sharded", p=P1279, regs=2,
                 ops=[["load", a], ["int", 0], ["square_mul", 0, 1],
                      ["save", b, {"iteration": 2}]])
    for r in res:
        assert r["out"] == [{"iteration": 1}, pow(1234567, 2, MP)]
    e = ShardedEngine(P1279, 2, device="cpu")
    assert shard_ckpt.load_sharded(e, b) == {"iteration": 2}
    assert e.get_int(0) == pow(1234567, 4, MP)


@pytest.mark.parametrize("s", [2, 4])
def test_jax_store_loads_into_port(tmp_path, s):
    """The JAX ShardedEngine on mesh8 saves (a spectral register among the
    three); s port ranks load it, and the restored multiplicand multiplies
    as the JAX's does."""
    d = str(tmp_path / "ck")
    j = _jax_engine(8)
    j.set_int(0, 0x5EED)
    j.square_mul(0)
    j.set(1, 77)
    j.set_multiplicand(2, 1)
    jck.save_sharded(j, d, {"iteration": 7})
    res = _ranks(tmp_path, "engine", s, engine="sharded", p=P1279, regs=3,
                 ops=[["load", d], ["int", 0], ["int", 1], ["mul", 0, 2, 3],
                      ["int", 0]])
    j.mul(0, 2, 3)
    x = 0x5EED * 0x5EED % MP
    for r in res:
        assert r["out"] == [{"iteration": 7}, x, 77, j.get_int(0)]
    assert j.get_int(0) == x * 77 * 3 % MP


@pytest.mark.parametrize("s", [2, 4])
def test_port_store_loads_into_jax(tmp_path, s):
    """s port ranks save; the JAX ShardedEngine on mesh8 loads the store
    (its CRCs, its manifest and its ranges) and multiplies by the restored
    multiplicand."""
    d = str(tmp_path / "ck")
    _ranks(tmp_path, "engine", s, engine="sharded", p=P1279, regs=3,
           ops=[["set", 0, 99], ["square_mul", 0, 3], ["set", 1, 5],
                ["set_multiplicand", 2, 1], ["save", d, {"iteration": 3}]])
    j = _jax_engine(8)
    assert jck.load_sharded(j, d) == {"iteration": 3}
    assert j.get_int(0) == 99 * 99 * 3 % MP and j.get_int(1) == 5
    j.mul(0, 2)
    assert j.get_int(0) == 99 * 99 * 3 * 5 % MP


def _saved(tmp_path, value=5):
    e = ShardedEngine(P1279, 3, device="cpu")
    e.set_int(0, value)
    d = str(tmp_path / "ck")
    shard_ckpt.save_sharded(e, d, {})
    return d


def test_corrupt_file_rejected(tmp_path):
    d = _saved(tmp_path, 99)
    f = os.path.join(d, "shard_0.bin")
    with open(f, "rb") as fh:
        blob = bytearray(fh.read())
    blob[8] ^= 0xFF
    with open(f, "wb") as fh:
        fh.write(bytes(blob))
    assert shard_ckpt.load_sharded(ShardedEngine(P1279, 3, device="cpu"),
                                   d) is None


def test_missing_manifest_is_aborted_save(tmp_path):
    d = _saved(tmp_path)
    os.unlink(os.path.join(d, "manifest.json"))
    assert shard_ckpt.load_sharded(ShardedEngine(P1279, 3, device="cpu"),
                                   d) is None


def test_wrong_shape_rejected(tmp_path):
    """A reg_count, an exponent or a transform size other than the store's
    is refused (None)."""
    d = _saved(tmp_path)
    assert shard_ckpt.load_sharded(ShardedEngine(P1279, 5, device="cpu"),
                                   d) is None
    assert shard_ckpt.load_sharded(ShardedEngine(1277, 3, device="cpu"),
                                   d) is None
    assert shard_ckpt.load_sharded(ShardedEngine(P1279, 3, device="cpu"),
                                   d) == {}


def test_mesh_engine_roundtrip_with_pending_carries(tmp_path):
    """MeshEngine on 2 ranks saves registers with pending row carries (the
    digits are settled first) and a multiplicand; one rank (no group)
    loads the store and multiplies by it."""
    n = 1 << 17
    p = int(n * 16.2) | 1
    mp = (1 << p) - 1
    d = str(tmp_path / "ck")
    _ranks(tmp_path, "engine", 2, p=p, n=n, regs=3,
           ops=[["set", 0, 3], ["square_mul_seq", 0, [1, 1]],
                ["set", 1, 11], ["set_multiplicand", 2, 1],
                ["save", d, {"iteration": 2}]])
    e = MeshEngine(p, 3, device="cpu", n=n)
    assert shard_ckpt.load_sharded(e, d) == {"iteration": 2}
    assert e.get_int(0) == 81
    e.mul(0, 2)
    assert e.get_int(0) == 81 * 11 % mp


def test_single_card_slab_rows_and_refusals():
    """TorchEngine's (reg_count, n) slab gives one range from digit 0; an
    engine without sharded rows raises TypeError."""
    e = TorchEngine(P1279, 2, device="cpu")
    e.set(1, 12345)
    rows, spectral = shard_ckpt._reg_digit_rows(e, 1)
    assert not spectral and len(rows) == 1 and rows[0][0] == 0
    assert (rows[0][1] == e.get_digits(1)).all()
    from prmers_tpu_torch.engine.np_engine import NumpyEngine
    with pytest.raises(TypeError):
        shard_ckpt._reg_digit_rows(NumpyEngine(P1279, 1), 0)


def test_gl_window_1_2_1_through_env_ranks(tmp_path):
    """One rank saves after 5 squarings; two ranks joined through the JAX
    package's PRMERS_COORDINATOR / PRMERS_NUM_PROCS / PRMERS_PROC_ID load
    it, run a Gerbicz-Li window (B squarings, the accumulator's multiply,
    the replay from the last-good copy, is_equal) and save; one rank
    loads that and holds the state and the accumulator."""
    seed, B = 0x5EED, 4
    e = ShardedEngine(P1279, 4, device="cpu")
    e.set_int(0, seed)
    for _ in range(5):
        e.square_mul(0, 1)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shard_ckpt.save_sharded(e, a, {"iteration": 5})
    res = _ranks(tmp_path, "engine", 2, jax_env=True, engine="sharded",
                 p=P1279, regs=4,
                 ops=[["load", a], ["copy", 2, 0], ["set", 1, 1],
                      ["square_mul_seq", 0, [1] * B],
                      ["set_multiplicand", 3, 0], ["mul", 1, 3],
                      ["square_mul_seq", 2, [1] * B], ["equal", 0, 2],
                      ["save", b, {"iteration": 5 + B}]])
    state = pow(pow(seed, 1 << 5, MP), 1 << B, MP)
    for r in res:
        assert r["out"] == [{"iteration": 5}, True]
    e2 = ShardedEngine(P1279, 4, device="cpu")
    assert shard_ckpt.load_sharded(e2, b) == {"iteration": 9}
    assert e2.get_int(0) == state and e2.get_int(1) == state
    assert e2.get_int(2) == state
