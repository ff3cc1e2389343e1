"""The mesh path of the port (parallel/dist, parallel/sharded_kernels,
parallel/mesh_engine, K8) on the CPU: gloo ranks against the JAX
package's mesh on the 8-device CPU mesh of tests/conftest.py, its kernels
in Pallas interpret mode, and against big-int.

The ranks are processes running tests/torch_mesh_worker.py, which imports
the port only (no jax), one torch thread each, meeting through a file://
rendezvous in tmp_path so that xdist workers never race for a port. The
JAX side runs here. Inputs come from numpy seeds. Tolerance: none; the
arithmetic is exact, so the moves, the views, K8, the steps' digits and
carries and the engines' values agree bit for bit (a spectral value mod P,
after canon). The JAX engine runs with PRMERS_MESH_SEQ_STEPWISE, so its
LL step is square, then sub, and the port's fused sub2 is held to
big-int. The comparisons are split into many test functions so that
xdist spreads them over its workers: under the tier-1 command (6 workers)
the JAX step and engine tests take 14-23 s each (interpret-mode
compiles), the 4-rank engine test 8 s, the 43 cases about 130 s of worker
time in all, and the whole tier-1 run took 289 s with them. The CUDA
launches of the shard views are held against their plain versions on the
card (test_torch_kernels.py, chip_smoke.py).
"""

import os
import pickle
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from prmers_tpu.core.field import P as GP
from prmers_tpu.core.plan import build_plan
from prmers_tpu.utils import digits as dg
from prmers_tpu.utils import gmp
from prmers_tpu_torch import convert
from prmers_tpu_torch.core import checkpoints as tck
from prmers_tpu_torch.engine import factory
from prmers_tpu_torch.engine.fourstep_engine import (FourStepEngine,
                                                     host_tables)
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk
from prmers_tpu_torch.parallel import dist
from prmers_tpu_torch.parallel import mesh_engine as tme
from prmers_tpu_torch.parallel import sharded_kernels as sk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
N2 = 1 << 17                    # (R1, R2, C) = (64, 2, 1024): s = 2
P2 = int(N2 * 16.2) | 1
N4 = 1 << 18                    # (64, 4, 1024): s = 2 and 4
P4 = int(N4 * 16.2) | 1
BLOCK = tfs.Pipeline(rowcarry=False)
_u64 = convert.from_pairs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranks(tmp_path, scenario, s, jax_env=False, **args):
    """Run the worker's scenario on s gloo ranks; returns each rank's
    result, in rank order. They meet through a file:// rendezvous, or with
    jax_env through the JAX package's PRMERS_COORDINATOR variables (a
    tcp:// rendezvous on a free local port)."""
    d = tmp_path / f"{scenario}_{s}"
    d.mkdir()
    with open(d / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    if jax_env:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env.update(PRMERS_COORDINATOR=f"127.0.0.1:{port}",
                   PRMERS_NUM_PROCS=str(s))
        rank_env = "PRMERS_PROC_ID"
    else:
        env["WORLD_SIZE"] = str(s)
        rank_env = "RANK"
    cmd = [sys.executable, WORKER, scenario,
           "env" if jax_env else str(d / "rdzv"), str(d),
           str(d / "args.pkl")]
    procs = [subprocess.Popen(cmd, env=dict(env, **{rank_env: str(r)}),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(s)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {s}:\n{out[-4000:]}"
    res = []
    for r in range(s):
        with open(d / f"{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def _value(p, rng):
    return int.from_bytes(rng.bytes(p // 8 + 1), "little") % ((1 << p) - 1)


def _canon(a64):
    a64 = np.asarray(a64, dtype=np.uint64)
    return np.where(a64 >= np.uint64(GP), a64 - np.uint64(GP), a64)


def _residues(rng, shape):
    y = rng.integers(0, GP, size=shape, dtype=np.uint64)
    y.reshape(-1)[::97] = GP - 1
    y.reshape(-1)[5::211] = 1 << 63
    return y


def _t(a64):
    return tgl.from_numpy_u64(np.ascontiguousarray(a64), "cpu")


def _np(x):
    return tgl.to_numpy_u64(x)


def _mesh(s):
    from prmers_tpu.parallel.sharded import make_mesh
    return make_mesh(s)


def _ja(a):
    import jax.numpy as jnp
    return (jnp.full((1, 1), np.uint32(a)), jnp.zeros((1, 1), jnp.uint32))


def _same_states(port_states, jax_state, s):
    """Each rank's (digits, carries) against its rows of the JAX state."""
    want = convert.mesh_state_from_jax(*jax_state, s)
    for (x, co), (wx, wc) in zip(port_states, want):
        assert (x == wx).all()
        assert (co == wc).all()


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2, 4])
def test_moves_match_lax(tmp_path, s):
    """to_r2_sharded / to_r1_sharded against lax.all_to_all(tiled) and
    back, ring_prev against lax.ppermute to rank + 1, all_gather_scalars
    against lax.all_gather, each rank's result against the JAX shard's."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from prmers_tpu.parallel.sharded import LIMB, shard_map
    shape = (8, 4, 3)
    port = _ranks(tmp_path, "moves", s, shape=shape, seed=s)
    full = np.random.default_rng(s).integers(-(1 << 62), 1 << 62,
                                             size=shape, dtype=np.int64)
    perm = [(i, (i + 1) % s) for i in range(s)]

    def local(x):
        y = lax.all_to_all(x, LIMB, 1, 0, tiled=True)
        back = lax.all_to_all(y, LIMB, 0, 1, tiled=True)
        ring = lax.ppermute(x[-1:], LIMB, perm)
        gather = lax.all_gather(x[0, 0, :2], LIMB)
        return y[None], back[None], ring[None], gather[None]

    spec4 = P(LIMB, None, None, None)
    fn = jax.jit(shard_map(local, mesh=_mesh(s),
                           in_specs=(P(LIMB, None, None),),
                           out_specs=(spec4, spec4, spec4,
                                      P(LIMB, None, None)),
                           check_rep=False))
    y, back, ring, gather = (np.asarray(a) for a in fn(jnp.asarray(full)))
    for r, got in enumerate(port):
        assert got["to_r2"].shape == (8, 4 // s, 3)
        assert (got["to_r2"] == y[r]).all()
        assert (got["back"] == back[r]).all()
        assert (got["back"] == full[r * 8 // s:(r + 1) * 8 // s]).all()
        assert (got["ring"] == ring[r]).all()
        assert (got["gather"] == gather[r]).all()
        assert (got["whole"] == full).all()


def test_init_from_jax_env(tmp_path):
    """init_from_env joins the group that the JAX package's
    PRMERS_COORDINATOR, PRMERS_NUM_PROCS and PRMERS_PROC_ID describe (a
    tcp:// rendezvous), each rank at its PRMERS_PROC_ID."""
    shape = (8, 4, 3)
    full = np.random.default_rng(9).integers(-(1 << 62), 1 << 62,
                                             size=shape, dtype=np.int64)
    port = _ranks(tmp_path, "moves", 2, jax_env=True, shape=shape, seed=9)
    for r, got in enumerate(port):
        assert (got["back"] == full[r * 4:(r + 1) * 4]).all()
        assert (got["whole"] == full).all()


def test_init_from_env_refuses_ranks_beyond_the_cards(monkeypatch):
    """Without LOCAL_RANK the card is cuda:RANK, so a group larger than
    the host's cards (a launch across hosts) raises before it joins."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PRMERS_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("PRMERS_NUM_PROCS", "2")
    monkeypatch.setenv("PRMERS_PROC_ID", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        dist.init_from_env()
    assert not dist.initialized()


# ---------------------------------------------------------------------------
# the shard views of the tables and K8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full18():
    """The port's tables at n = 2^18 (row carry), whole, and inputs."""
    plan = build_plan(P4, n=N4)
    kt = host_tables(tfs.FourStepPlan.from_plan(plan))
    t = tk.DevTables.from_host(kt, "cpu")
    rng = np.random.default_rng(18)
    x = dg.int_to_digits(_value(P4, rng), plan.widths).reshape(t.shape)
    co = rng.integers(0, 1 << 40, size=t.row_carry_shape, dtype=np.uint64)
    return dict(plan=plan, kt=kt, t=t, x=x, co=co,
                y=_residues(rng, t.shape), u=_residues(rng, t.shape))


def _views(f, s, rank):
    return tuple(tk.DevTables.from_host(f["kt"], "cpu", view, rank, s)
                 for view in (tk.R2_VIEW, tk.R1_VIEW))


@pytest.mark.parametrize("s,rank", [(2, 1), (4, 0), (4, 3)])
@pytest.mark.parametrize("kern", ["k1", "k3", "k4", "k5_k6", "k8"])
def test_shard_views_match_full_plain(full18, kern, s, rank):
    """Each kernel on a rank's view (the wrappers, which take the plain
    versions for CPU tensors) against the rank's slice of the full plain
    kernel: r2 slices for K1, K3, K4, r1 slices for K5, K6, K6b, K8."""
    t = full18["t"]
    t2, t1 = _views(full18, s, rank)
    R1, R2, C = t.shape
    r1 = slice(rank * R1 // s, (rank + 1) * R1 // s)
    r2 = slice(rank * R2 // s, (rank + 1) * R2 // s)
    assert t2.shape == (R1, R2 // s, C) and t1.shape == (R1 // s, R2, C)
    x, co, y, u = (_t(full18[k]) for k in ("x", "co", "y", "u"))
    if kern == "k1":
        # the rolled carries, moved, rolled back one unit for K1's roll
        c2 = tk.roll_row_carries(co)[:, r2].contiguous()
        c2 = torch.roll(c2.reshape(-1), -1).reshape(c2.shape)
        want = tk.p1_carry_plain(t, x, co)[:, r2]
        assert torch.equal(tk.p1_carry_pass(t2, x[:, r2].contiguous(), c2),
                           want)
    elif kern == "k3":
        for a, sub2 in ((1, False), (3, False), (1, True)):
            d, c = tk.p7_carry_plain(t, y, a, sub2)
            ds, cs = tk.p7_carry_pass(t2, y[:, r2].contiguous(), a=a,
                                      sub2=sub2, s2=2 if rank == 0 else 0)
            assert torch.equal(ds, d[:, r2]) and torch.equal(cs, c[:, r2])
    elif kern == "k4":
        for inverse in (False, True):
            v = y if inverse else x
            assert torch.equal(
                tk.axis0_pass(t2, v[:, r2].contiguous(), inverse),
                tk.axis0_plain(t, v, inverse)[:, r2])
        # the r2 view has no block spread tables: carries are refused
        with pytest.raises(ValueError, match="bwt"):
            tk.axis0_pass(t2, x[:, r2].contiguous(), False,
                          co=torch.zeros((R1, 1), dtype=torch.int64))
    elif kern == "k5_k6":
        ys = y[r1].contiguous()
        for which in ("p2", "p6"):
            assert torch.equal(tk.axis1_pass(t1, ys, which),
                               tk.axis1_plain(t, y, which)[r1])
        for mode in ("sqr", "fwd", "mul"):
            um = u if mode == "mul" else None
            got = tk.fused_c_pass(t1, ys, mode, r2fold=False,
                                  u=None if um is None else u[r1].clone())
            assert torch.equal(
                got, tk.fused_c_plain(t, y, mode, um, r2fold=False)[r1])
        for op in ("sqr", ""):
            assert torch.equal(tk.fused_c_invh_pass(t1, ys, op),
                               tk.fused_c_invh_plain(t, y, op)[r1])
    else:
        rounds = tfs.k8_rounds(t.fp)
        z = _t(_canon(full18["y"]))
        for a in (1, 3):
            d, c = tk.block_carry_plain(t, z, a, rounds)
            ds, cs = tk.block_carry_local(t1, z[r1].contiguous(), a)
            assert torch.equal(ds, d[r1]) and torch.equal(cs, c[r1])
            assert tk.calls["k8_local"] == 0      # the plain version ran


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("a", [None, 3])
def test_k8_matches_k4_local(full18, monkeypatch, s, a):
    """The plain K8 on the last rank's r1 blocks against
    sharded_pallas._k4_local on the same slice (interpret mode): digits
    and (R1/s, 1) block carries bit for bit, values up to P - 1."""
    import jax.numpy as jnp
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.parallel import sharded_pallas as sp
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    rank = s - 1
    _t2, t1 = _views(full18, s, rank)
    R1 = full18["t"].shape[0]
    r1 = slice(rank * R1 // s, (rank + 1) * R1 // s)
    y = _canon(full18["y"])[r1]
    fpj = fs.FourStepPlan.from_plan(full18["plan"])
    wd = full18["plan"].widths.reshape(full18["t"].shape)[r1]
    y0, y1 = convert.to_pairs(y)
    d0, d1, c0, c1 = sp._k4_local(
        fpj, jnp.asarray(y0), jnp.asarray(y1),
        jnp.asarray(wd.astype(np.uint32)), a=None if a is None else _ja(a))
    d, co = tk.block_carry_local(t1, _t(y), a or 1)
    assert co.shape == (R1 // s, 1)
    assert (_u64(d0, d1) == _np(d)).all()
    assert (_u64(c0, c1) == _np(co)).all()


def test_k8_rounds_rule(full18):
    """K8 splits until the residual is at most 1 (sharded_pallas.py:
    209-215), more rounds than K7's rule."""
    fp = full18["t"].fp
    wmin = int(fp.widths.min())
    rounds = 1
    while fp.max_word * 4 >> (rounds * wmin) > 1:
        rounds += 1
    assert tfs.k8_rounds(fp) == max(rounds, 2) > tfs.carry_rounds(fp)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a", [1, 3])
def test_block_step_matches_pallas_sharded_step(tmp_path, monkeypatch, a):
    """ShardedStep on the block carry (K4, K5, K6, K5, K4 inverse, K8) on 2
    ranks against the JAX PallasShardedStep under PRMERS_NO_ROWCARRY on a
    2-device mesh at n = 2^17, from the same random digits: two steps of
    x^2 * a, each rank's digits and block carries bit for bit, and the
    value equal to big-int."""
    from prmers_tpu.parallel.sharded_pallas import PallasShardedStep
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PRMERS_NO_ROWCARRY", "1")
    plan = build_plan(P2, n=N2)
    v = _value(P2, np.random.default_rng(40 + a))
    digits = dg.int_to_digits(v, plan.widths)
    port = _ranks(tmp_path, "block_step", 2, p=P2, n=N2, digits=digits,
                  a=[a, a])
    j = PallasShardedStep(P2, _mesh(2), n=N2)
    assert not j.tables.rowcarry
    j.set_digits(digits)
    mp = (1 << P2) - 1
    for i in range(2):
        j.step(1, a)
        _same_states([r["states"][i] for r in port],
                     (j.x0, j.x1, j.co0, j.co1), 2)
        v = gmp.mulmod(v, v * a, mp)
        assert port[0]["ints"][i] == port[1]["ints"][i] == j.get_int() == v
    for r in port:       # the plain versions ran: no launch was counted
        assert not any(r["calls"].values())


def test_sharded_step_single_rank_bigint():
    """ShardedStep with no group (s = 1) on both pipelines: squarings, x3
    and the multiplicand (row carry) against big-int."""
    mp = (1 << P2) - 1
    rng = np.random.default_rng(44)
    v, w = _value(P2, rng), _value(P2, rng)
    plan = build_plan(P2, n=N2)
    for pipe in (BLOCK, tfs.Pipeline()):
        st = sk.ShardedStep(P2, n=N2, pipe=pipe, device="cpu")
        assert st.tables.s == 1 and st.tables.rowcarry == pipe.rowcarry
        st.set_digits(dg.int_to_digits(v, plan.widths))
        st.step(1, 3)
        st.step(1)
        want = gmp.mulmod(v, v * 3, mp)
        want = gmp.mulmod(want, want, mp)
        assert st.get_int() == want
    st.prepare_multiplicand(dg.int_to_digits(w, plan.widths))
    st.mul(3)
    assert st.get_int() == gmp.mulmod(want, w * 3, mp)
    with pytest.raises(ValueError):
        sk.ShardedStep(P2, n=N2, pipe=BLOCK,
                       device="cpu").prepare_multiplicand(plan.widths * 0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _jax_engine(monkeypatch, regs=4):
    from prmers_tpu.parallel.mesh_engine import MeshPallasEngine
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PRMERS_MESH_SEQ_STEPWISE", "1")
    return MeshPallasEngine(P2, regs, _mesh(2), n=N2)


def _jax_state(j, r):
    return tuple(j.regs[r][:4])


def test_engine_squarings_match_mesh_pallas_engine(tmp_path, monkeypatch):
    """square_mul_seq([1, 3]) on 2 ranks against the JAX MeshPallasEngine
    on 2 devices: the unsettled digits and row carries bit for bit, and
    get_int equal to big-int."""
    mp = (1 << P2) - 1
    v = _value(P2, np.random.default_rng(50))
    ops = [["set", 0, v], ["square_mul_seq", 0, [1, 3]], ["state", 0],
           ["int", 0]]
    port = _ranks(tmp_path, "engine", 2, p=P2, n=N2, regs=2, ops=ops)
    j = _jax_engine(monkeypatch, 2)
    j.set(0, v)
    j.square_mul_seq(0, [1, 3])
    _same_states([r["out"][0] for r in port], _jax_state(j, 0), 2)
    want = gmp.mulmod(v, v, mp)
    want = gmp.mulmod(want, want * 3, mp)
    assert port[0]["out"][1] == port[1]["out"][1] == j.get_int(0) == want
    # per squaring three moves each way (x and the carries to r2 sharding,
    # K1's output back, the C-transform's out, digits and carries back)
    for r in port:
        assert r["dist"]["to_r2"] == r["dist"]["to_r1"] == 6


def test_engine_mul_matches_mesh_pallas_engine(tmp_path, monkeypatch):
    """set_multiplicand + mul(.., 3) on 2 ranks against the JAX engine:
    the state after mul bit for bit, get_int equal to big-int."""
    mp = (1 << P2) - 1
    rng = np.random.default_rng(51)
    v, w = _value(P2, rng), _value(P2, rng)
    ops = [["set", 0, v], ["set", 1, w], ["set_multiplicand", 2, 1],
           ["mul", 0, 2, 3], ["state", 0], ["int", 0]]
    port = _ranks(tmp_path, "engine", 2, p=P2, n=N2, regs=3, ops=ops)
    j = _jax_engine(monkeypatch, 3)
    j.set(0, v)
    j.set(1, w)
    j.set_multiplicand(2, 1)
    j.mul(0, 2, 3)
    _same_states([r["out"][0] for r in port], _jax_state(j, 0), 2)
    want = gmp.mulmod(v, w * 3, mp)
    assert port[0]["out"][1] == port[1]["out"][1] == j.get_int(0) == want


def test_engine_ll_and_linear_match_mesh_pallas_engine(tmp_path,
                                                       monkeypatch):
    """The fused LL step (the -2 on rank 0 only), a sparse sub (M_p - a
    has all-ones digits: the ring's lookahead over every rank), a sub
    through zero, add and sub_reg on 2 ranks, against the JAX engine
    (square, then sub) and big-int."""
    mp = (1 << P2) - 1
    rng = np.random.default_rng(52)
    v, w = _value(P2, rng), _value(P2, rng)
    ops = [["set", 1, w], ["square_sub2_seq", 1, 1], ["int", 1],
           ["set", 3, 81], ["sub", 3, 2], ["int", 3], ["sub", 3, 100],
           ["int", 3], ["set", 0, v], ["add", 0, 1], ["int", 0],
           ["sub_reg", 0, 3], ["int", 0]]
    port = _ranks(tmp_path, "engine", 2, p=P2, n=N2, regs=4, ops=ops)
    j = _jax_engine(monkeypatch)
    ll = (gmp.mulmod(w, w, mp) - 2) % mp
    want = [ll, 79, (79 - 100) % mp, (v + ll) % mp, (v + ll + 21) % mp]
    got = []
    j.set(1, w)
    j.square_sub2_seq(1, 1)
    got.append(j.get_int(1))
    j.set(3, 81)
    j.sub(3, 2)
    got.append(j.get_int(3))
    j.sub(3, 100)
    got.append(j.get_int(3))
    j.set(0, v)
    j.add(0, 1)
    got.append(j.get_int(0))
    j.sub_reg(0, 3)
    got.append(j.get_int(0))
    assert got == want
    assert port[0]["out"] == port[1]["out"] == want


def test_engine_matches_fourstep_engine(tmp_path):
    """MeshEngine on 2 ranks against the port's single-card FourStepEngine
    (K2 there, K5 + K6 + K5 on the mesh; K3 canonicalizes, so the digits
    agree): the unsettled state after squarings, the checkpoint bytes with
    pending carries and a multiplicand, and a restore of the single-card
    checkpoint into the mesh."""
    mp = (1 << P2) - 1
    rng = np.random.default_rng(53)
    v, w = _value(P2, rng), _value(P2, rng)
    e = FourStepEngine(P2, 3, plan=build_plan(P2, n=N2), device="cpu")
    e.set(0, v)
    e.set(1, w)
    e.square_mul_seq(0, [3, 1])
    state = (_np(e.regs[0][0]), _np(e.regs[0][1]))
    e.set_multiplicand(2, 1)
    blob = e.get_checkpoint()
    e.mul(0, 2)
    after = e.get_int(0)
    ops = [["set", 0, v], ["set", 1, w], ["square_mul_seq", 0, [3, 1]],
           ["state", 0], ["set_multiplicand", 2, 1], ["ckpt"],
           ["set", 0, 5], ["set_checkpoint", blob], ["mul", 0, 2],
           ["int", 0]]
    port = _ranks(tmp_path, "engine", 2, p=P2, n=N2, regs=3, ops=ops)
    R1 = e.t.shape[0]
    for r, res in enumerate(port):
        x, co = res["out"][0]
        assert (x == state[0][r * R1 // 2:(r + 1) * R1 // 2]).all()
        assert (co == state[1][r * R1 // 2:(r + 1) * R1 // 2]).all()
        assert res["out"][1] == blob
        assert res["out"][2] == after
    x0 = gmp.mulmod(v, v * 3, mp)
    assert after == gmp.mulmod(gmp.mulmod(x0, x0, mp), w, mp)


def test_engine_four_ranks_bigint(tmp_path):
    """MeshEngine on 4 ranks at n = 2^18 against big-int: squarings, x3,
    multiplicand + mul, the fused LL step, a sparse sub, add and
    sub_reg."""
    mp = (1 << P4) - 1
    rnd = random.Random(54)
    v, w = rnd.getrandbits(P4 - 1), rnd.getrandbits(P4 - 1)
    ops = [["set", 0, v], ["set", 1, w], ["square_mul_seq", 0, [1, 3]],
           ["int", 0], ["set_multiplicand", 2, 1], ["mul", 0, 2, 3],
           ["int", 0], ["square_sub2_seq", 1, 2], ["int", 1],
           ["set", 3, 81], ["sub", 3, 2], ["int", 3], ["sub", 3, 100],
           ["int", 3], ["add", 0, 1], ["int", 0], ["sub_reg", 0, 1],
           ["int", 0]]
    port = _ranks(tmp_path, "engine", 4, p=P4, n=N4, regs=4, ops=ops)
    a = gmp.mulmod(v, v, mp)
    a = gmp.mulmod(a, a * 3, mp)
    b = gmp.mulmod(a, w * 3, mp)
    ll = w
    for _ in range(2):
        ll = (gmp.mulmod(ll, ll, mp) - 2) % mp
    want = [a, b, ll, 79, (79 - 100) % mp, (b + ll) % mp, b]
    for res in port:
        assert res["out"] == want
        assert res["dist"]["to_r2"] > 0 and res["dist"]["all_gather"] > 0


# ---------------------------------------------------------------------------
# shapes, factory, checkpoints, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,s", [(756839, 1), (756839, 2), (P2, 2),
                                 (P2, 4), (P4, 4), (P4, 8), (136279841, 4),
                                 (136279841, 64), (136279841, 128)])
def test_mesh_eligible_matches_jax(p, s):
    from prmers_tpu.parallel.mesh_engine import mesh_pallas_eligible
    n = N2 if p == P2 else N4 if p == P4 else None
    assert tme.mesh_eligible(p, s, n=n) == mesh_pallas_eligible(p, s, n=n)


def test_factory_backends(monkeypatch):
    """"sharded" (argument or PRMERS_BACKEND) gives the mesh engine, on a
    group of one here; "auto" without a group the four-step engine; the
    mesh refuses the block carry and shapes it does not take."""
    for k in ("PRMERS_NO_ROWCARRY", "PRMERS_XLA_CARRY", "PRMERS_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    assert dist.process_count() == 1
    e = factory.create_engine(756839, 2, device="cpu", backend="sharded")
    assert isinstance(e, tme.MeshEngine) and e.tables.s == 1
    e.set(0, 3)
    e.square_mul(0, 3)
    assert e.get_int(0) == 27
    assert isinstance(factory.create_engine(756839, 2, device="cpu"),
                      FourStepEngine)
    monkeypatch.setenv("PRMERS_BACKEND", "sharded")
    assert isinstance(factory.create_engine(756839, 2, device="cpu"),
                      tme.MeshEngine)
    monkeypatch.setenv("PRMERS_NO_ROWCARRY", "1")
    with pytest.raises(ValueError, match="row carry"):
        factory.create_engine(756839, 2, device="cpu")
    monkeypatch.delenv("PRMERS_NO_ROWCARRY")
    monkeypatch.setenv("PRMERS_XLA_CARRY", "1")
    with pytest.raises(ValueError, match="R1, R2, C"):
        factory.create_engine(756839, 2, device="cpu")
    for b in ("jax", "numpy"):
        with pytest.raises(NotImplementedError):
            factory.create_engine(756839, 2, device="cpu", backend=b)
    with pytest.raises(ValueError, match="must divide"):
        sk.check_mesh(tfs.FourStepPlan.from_plan(build_plan(756839)), 2)


def test_checkpoints_written_by_rank_zero_only(tmp_path, monkeypatch):
    data = tck.CheckpointData(p=127, mode_tag=1, iteration=5, elapsed=1.0,
                              extra=b"", regs=b"\0" * 16)
    path = str(tmp_path / "m_127.ckpt")
    monkeypatch.setattr(dist, "rank", lambda: 1)
    tck.write_checkpoint(path, data)
    assert not os.path.exists(path)
    monkeypatch.setattr(dist, "rank", lambda: 0)
    tck.write_checkpoint(path, data)
    assert tck.read_checkpoint(path, 127, 1).iteration == 5
    monkeypatch.setattr(dist, "rank", lambda: 1)
    tck.delete_checkpoints(path)
    assert os.path.exists(path)


@pytest.mark.parametrize("rowcarry", [True, False])
def test_mesh_state_conversion_round_trip(rowcarry):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 40, size=(8, 4, 256), dtype=np.uint64)
    co = rng.integers(0, 1 << 40, size=(8, 4, 2) if rowcarry else (8, 1),
                      dtype=np.uint64)
    (x0, x1), (c0, c1) = convert.state_to_jax(x, co)
    ranks = convert.mesh_state_from_jax(x0, x1, c0, c1, 4)
    assert len(ranks) == 4 and ranks[1][0].shape == (2, 4, 256)
    assert (ranks[3][1] == co[6:]).all()
    back = convert.mesh_state_to_jax(ranks)
    for got, want in zip(back, ((x0, x1), (c0, c1))):
        assert all((g == w).all() for g, w in zip(got, want))
