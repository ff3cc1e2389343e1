"""The XLA-form mesh engine of the port (parallel/sharded.py), the factory's
route between it and MeshEngine, and the __graft_entry__ twin
(graft_entry.py), on the CPU.

The ranks are gloo processes of tests/torch_mesh_worker.py (the port
only), as in tests/test_torch_mesh.py. They are held against the JAX
package's ShardedEngine on conftest's CPU mesh (make_mesh(2), make_mesh(4)),
which runs a few ops each, never a long chain (its collective rendezvous
gives up after 40 s under load), and against big-int: the M1279 PRP and
the M3217 LL of tests/test_sharded.py:68-92 on the port side. Inputs come
from seeded generators. Tolerance: none; digits, spectral words (both
canonical mod P), checkpoints and res64 agree bit for bit.
"""

import random

import numpy as np
import pytest
import torch

from prmers_tpu.core.field import FieldOps
from prmers_tpu.core.plan import cached_plan as jcached_plan
from prmers_tpu.ops import ntt as jntt
from prmers_tpu.utils import gmp
from prmers_tpu_torch import graft_entry
from prmers_tpu_torch.core.plan import build_plan, cached_plan
from prmers_tpu_torch.engine import factory
from prmers_tpu_torch.engine.fourstep_engine import FourStepEngine
from prmers_tpu_torch.engine.torch_engine import TorchEngine
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.parallel import dist
from prmers_tpu_torch.parallel import mesh_engine as tme
from prmers_tpu_torch.parallel import sharded as tsh
from prmers_tpu_torch.utils import digits as dg
from test_torch_mesh import _ranks

ENV_NAMES = ("PRMERS_SHARDED_IMPL", "PRMERS_NO_ROWCARRY", "PRMERS_XLA_CARRY",
             "PRMERS_BACKEND", "PRMERS_NO_PALLAS")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_NAMES:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _mesh(s):
    from prmers_tpu.parallel.sharded import make_mesh
    return make_mesh(s)


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,s,rank", [(1279, 2, 1), (9941, 4, 0),
                                      (9941, 4, 3), (1600003, 2, 1)])
def test_rank_tables_match_ntt_tables(p, s, rank):
    """rank_tables against the reference's whole tables (NttTables.from_plan
    on numpy, sharded._mid_full): the rank's rows of the weights and of
    mid_i, its columns of the inverse weights and of mid_f, its widths and
    masks, and the stage twiddles, word for word (p = 1600003 is a
    radix-5 plan, n = 81920)."""
    from prmers_tpu.parallel.sharded import _mid_full
    Fnp = FieldOps(np)
    plan = jcached_plan(p)
    t = jntt.NttTables.from_plan(plan, np)
    R, C, n = t.R, t.C, t.n
    got = tsh.rank_tables(cached_plan(p), s, rank)
    rows = slice(rank * R // s, (rank + 1) * R // s)
    cols = slice(rank * C // s, (rank + 1) * C // s)
    digits = slice(rank * n // s, (rank + 1) * n // s)
    want = {"w_rc": t.weights.reshape(R, C)[rows],
            "iw_rc": t.inv_weights_n.reshape(R, C)[:, cols],
            "mid_f": _mid_full(t, False, Fops=Fnp)[:, cols],
            "mid_i": _mid_full(t, True, Fops=Fnp)[rows],
            "wid": t.widths[digits], "msk": t.masks[digits]}
    for k, w in want.items():
        assert np.array_equal(np.asarray(got[k]).astype(np.uint64), w), k
    for mine, ref in ((got["stages_r"], t.stages_r),
                      (got["stages_c"], t.stages_c)):
        assert [m.radix for m in mine] == [r.radix for r in ref]
        for m, r in zip(mine, ref):
            assert np.array_equal(m.tw, r.tw)
            assert np.array_equal(m.tw_inv, r.tw_inv)


def test_tables_refuse_a_mesh_that_does_not_divide():
    """s must divide R and C of the any-size plan (sharded.py:205-207):
    ValueError, as the reference's."""
    plan = cached_plan(9941)                    # R = 32, C = 16
    with pytest.raises(ValueError, match="must divide"):
        tsh.rank_tables(plan, 3, 0)
    with pytest.raises(ValueError, match="must divide"):
        tsh.rank_tables(plan, 32, 0)


# ---------------------------------------------------------------------------
# the engine against the JAX ShardedEngine
# ---------------------------------------------------------------------------

def _jax_ops(j, ops, jax_psum):
    out = []
    for op, *a in ops:
        if op == "raw":
            out.append(j.get_raw_tagged(a[0]))
        elif op == "res64":
            out.append(int(jax_psum(j.tables, j.regs[a[0]])))
        elif op == "ckpt":
            out.append(j.get_checkpoint())
        elif op == "int":
            out.append(j.get_int(a[0]))
        else:
            getattr(j, op)(*a)
    return out


@pytest.mark.parametrize("s", [2, 4])
def test_engine_matches_jax_sharded_engine(tmp_path, s):
    """The port's ShardedEngine on s ranks against the JAX ShardedEngine on
    make_mesh(s) at M1279, op for op: squarings (a = 1, 3), a spectral
    multiplicand and mul x 3, add, sub_reg, sub, add_small, psum_res64 and
    the checkpoint bytes (a spectral register flagged); then the JAX's
    checkpoint restored into the port (and the port's into the JAX) and
    mul by the restored multiplicand."""
    from prmers_tpu.parallel.sharded import ShardedEngine as JShardedEngine
    from prmers_tpu.parallel.sharded import psum_res64 as jpsum
    p = 1279
    mp = (1 << p) - 1
    rnd = random.Random(60 + s)
    v, w = rnd.randrange(mp), rnd.randrange(mp)
    ops = [["set", 0, v], ["set", 1, w], ["square_mul", 0, 1], ["raw", 0],
           ["square_mul", 0, 3], ["raw", 0], ["set_multiplicand", 2, 1],
           ["raw", 2], ["mul", 0, 2, 3], ["raw", 0], ["add", 0, 1],
           ["raw", 0], ["sub_reg", 0, 1], ["raw", 0], ["sub", 0, 2],
           ["add_small", 0, 12345], ["raw", 0], ["res64", 0], ["ckpt"]]
    j = JShardedEngine(p, 3, _mesh(s))
    want = _jax_ops(j, ops, jpsum)
    jblob = want[-1]
    tail = [["set", 0, 5], ["set", 1, 7], ["set_checkpoint", jblob],
            ["mul", 1, 2, 3], ["int", 1], ["int", 0]]
    port = _ranks(tmp_path, "engine", s, engine="sharded", p=p, regs=3,
                  ops=ops + tail)
    j.set_checkpoint(port[0]["out"][len(want) - 1])
    j.mul(1, 2, 3)
    x = v * v % mp
    x = x * x * 3 % mp
    x = x * w * 3 % mp
    x = (x - 2 + 12345) % mp
    for res in port:
        got = res["out"]
        for k, (g, wv) in enumerate(zip(got, want)):
            if isinstance(wv, tuple):
                assert np.array_equal(g[0], wv[0]) and g[1] == wv[1], k
            else:
                assert g == wv, k
        assert got[len(want):] == [j.get_int(1), x]
        assert got[len(want) - 2] == x & ((1 << 64) - 1)
        assert j.get_int(1) == w * w % mp * 3 % mp
        assert res["dist"]["to_r2"] > 0 and res["dist"]["to_r1"] > 0


def test_engine_prp_m1279_two_ranks(tmp_path):
    """The PRP driver with Gerbicz-Li checks on the port's ShardedEngine over
    2 ranks: M1279 is prime (tests/test_sharded.py:68-79)."""
    res = _ranks(tmp_path, "prp", 2, engine="sharded", p=1279, regs=8,
                 mode="prp", save_dir=str(tmp_path / "run"))
    assert [r["prime"] for r in res] == [True, True]
    assert {r["res64"] for r in res} == {"0000000000000001"}


@pytest.mark.heavy
def test_engine_ll_m3217_four_ranks(tmp_path):
    """LL on the port's ShardedEngine over 4 ranks: M3217 is prime
    (tests/test_sharded.py:81-92; heavy, as the reference marks it: ~53 s
    of 3215 squarings with ten collectives each on gloo)."""
    res = _ranks(tmp_path, "prp", 4, engine="sharded", p=3217, regs=8,
                 mode="ll", save_dir=str(tmp_path / "run"))
    assert all(r["prime"] for r in res)


def test_engine_one_rank_matches_torch_engine():
    """On a group of one (no collective) the engine equals TorchEngine, the
    any-size engine whose field and transform it runs, register for
    register, a spectral multiplicand included, and its wraparound carry
    folds (M_p - 5)^2 to 25."""
    p = 9941
    mp = (1 << p) - 1
    rnd = random.Random(61)
    v, w = rnd.randrange(mp), rnd.randrange(mp)
    a, b = tsh.ShardedEngine(p, 3, device="cpu"), TorchEngine(p, 3,
                                                               device="cpu")
    for e in (a, b):
        e.set(0, v)
        e.set(1, w)
        e.square_mul(0, 3)
        e.set_multiplicand(2, 1)
        e.mul(0, 2)
        e.sub(0, 7)
    for r in range(3):
        assert np.array_equal(a.get_raw(r), b.get_raw(r)), r
    assert a.get_raw_tagged(2)[1] and not a.get_raw_tagged(0)[1]
    a.set(0, mp - 5)
    a.square_mul(0)
    assert a.get_int(0) == 25
    assert tsh.psum_res64(a.tables, a.regs[1]) == w & ((1 << 64) - 1)


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

def test_factory_routes_between_the_mesh_engines(clean_env):
    """"sharded" takes MeshEngine where it takes the shape and the pipeline
    and ShardedEngine elsewhere (factory.py:177-189): n = 512 (below the
    four-step engine), the block carry, the hybrid; PRMERS_SHARDED_IMPL=xla
    always ShardedEngine, =pallas always MeshEngine, whose refusal then
    raises; mesh_eligible answers for MeshEngine alone."""
    def make(p):
        return factory.create_engine(p, 2, device="cpu", backend="sharded")

    assert dist.process_count() == 1
    assert type(make(756839)) is tme.MeshEngine
    e = make(9941)
    assert type(e) is tsh.ShardedEngine and not tme.mesh_eligible(9941, 1)
    e.set(0, 3)
    e.square_mul(0, 3)
    assert e.get_int(0) == 27
    for name in ("PRMERS_NO_ROWCARRY", "PRMERS_XLA_CARRY"):
        clean_env.setenv(name, "1")
        assert type(make(756839)) is tsh.ShardedEngine, name
        assert tme.mesh_eligible(756839, 1)
        clean_env.setenv("PRMERS_SHARDED_IMPL", "pallas")
        with pytest.raises(ValueError):
            make(756839)
        clean_env.delenv("PRMERS_SHARDED_IMPL")
        clean_env.delenv(name)
    clean_env.setenv("PRMERS_SHARDED_IMPL", "xla")
    assert type(make(756839)) is tsh.ShardedEngine
    assert type(factory.create_engine(756839, 2, device="cpu")) is \
        FourStepEngine
    clean_env.setenv("PRMERS_SHARDED_IMPL", "pallas")
    with pytest.raises(NotImplementedError):
        make(9941)


def test_factory_falls_back_on_two_ranks(tmp_path):
    """On 2 ranks "sharded" gives ShardedEngine at M756839, where R2 = 1 and
    the mesh step has no shape (a squaring x 3 against big-int), and
    MeshEngine at n = 2^17, (64, 2, 1024)."""
    p = 756839
    mp = (1 << p) - 1
    v = random.Random(62).randrange(mp)
    res = _ranks(tmp_path, "engine", 2, engine="factory", p=p, regs=2,
                 ops=[["type"], ["set", 0, v], ["square_mul", 0, 3],
                      ["int", 0]])
    want = gmp.mulmod(v, v * 3, mp)
    assert [r["out"] for r in res] == [["ShardedEngine", want]] * 2
    p2 = int((1 << 17) * 16.2) | 1
    assert tme.mesh_eligible(p2, 2, n=1 << 17)
    assert not tme.mesh_eligible(p, 2)
    assert build_plan(p).n == 1 << 15


# ---------------------------------------------------------------------------
# the __graft_entry__ twin
# ---------------------------------------------------------------------------

def test_graft_entry_runs_on_the_cpu():
    """entry(): one any-size squaring at p = 9941 of the slab it hands out,
    3 -> 9, and x 3 from there."""
    fn, args = graft_entry.entry(device="cpu")
    regs = fn(*args)
    widths = cached_plan(9941).widths
    assert dg.digits_to_int(tgl.to_numpy_u64(regs[0]), widths) == 9
    regs = fn(regs, 0, 3)
    assert dg.digits_to_int(tgl.to_numpy_u64(regs[0]), widths) == 243


def test_graft_dryrun_multichip_on_gloo_ranks(capfd):
    """dryrun_multichip(2) on two gloo ranks: the ShardedEngine chain with
    psum_res64, the kernels' mesh step at n = 2^19 with the x3 step, and
    MeshEngine's chains, sub and checkpoint replay, each against big-int
    (a failed check raises in the rank and here)."""
    graft_entry.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert out.count("dryrun_multichip(2): ") == 3
