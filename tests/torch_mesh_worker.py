"""One rank of a CPU mesh test of the port (tests/test_torch_mesh.py).

    RANK=r WORLD_SIZE=s python tests/torch_mesh_worker.py SCENARIO \
        INIT_FILE OUT_DIR ARGS_PKL

joins a gloo group through the file:// rendezvous INIT_FILE (or, with
INIT_FILE "env", through dist.init_from_env and the JAX package's
PRMERS_COORDINATOR, PRMERS_NUM_PROCS and PRMERS_PROC_ID), runs the
scenario (its arguments a pickled dict in ARGS_PKL; its "env" entry, if
any, set in os.environ first) on the CPU with one
torch thread, and writes what it computed
to OUT_DIR/<rank>.pkl. It imports the port only: no jax, no prmers_tpu
(tests/conftest.py, which imports jax, is not loaded for a script).
"""

import os
import pickle
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from prmers_tpu_torch.ops import fourstep as tfs  # noqa: E402
from prmers_tpu_torch.ops import gl64 as gl  # noqa: E402
from prmers_tpu_torch.ops import kernels as tk  # noqa: E402
from prmers_tpu_torch.parallel import dist  # noqa: E402
from prmers_tpu_torch.parallel import sharded_kernels as sk  # noqa: E402
from prmers_tpu_torch.parallel import shard_ckpt  # noqa: E402
from prmers_tpu_torch.parallel.mesh_engine import MeshEngine  # noqa: E402
from prmers_tpu_torch.parallel.sharded import (ShardedEngine,  # noqa: E402
                                               psum_res64)


def _np(x):
    return gl.to_numpy_u64(x)


def moves(args):
    """The two all-to-all moves, the ring and the scalar gather on a
    rank's rows of one random int64 array."""
    rng = np.random.default_rng(args["seed"])
    full = rng.integers(-(1 << 62), 1 << 62, size=args["shape"],
                        dtype=np.int64)
    x = torch.from_numpy(dist.put_global(full))
    y = dist.to_r2_sharded(x)
    return {"to_r2": y.numpy(), "back": dist.to_r1_sharded(y).numpy(),
            "ring": dist.ring_prev(x[-1:]).numpy(),
            "gather": dist.all_gather_scalars(x[0, 0, :2]).numpy(),
            "whole": dist.global_gather(x).numpy()}


def block_step(args):
    """ShardedStep on the block carry: set_digits, then step(1, a) for
    each a; the rank's digits and block carries after each step."""
    st = sk.ShardedStep(args["p"], n=args["n"],
                        pipe=tfs.Pipeline(rowcarry=False), device="cpu")
    st.set_digits(np.asarray(args["digits"], dtype=np.uint64))
    out = {"states": [], "ints": []}
    for a in args["a"]:
        st.step(1, a)
        out["states"].append((_np(st.x), _np(st.co)))
        out["ints"].append(st.get_int())
    out["calls"] = dict(tk.calls)
    return out


def _engine(args):
    """The scenario's engine: "mesh" MeshEngine, "sharded" ShardedEngine,
    "factory" what create_engine(backend="sharded") gives under the
    scenario's environment."""
    kind = args.get("engine", "mesh")
    if kind == "mesh":
        return MeshEngine(args["p"], args["regs"], device="cpu",
                          n=args.get("n"))
    if kind == "sharded":
        return ShardedEngine(args["p"], args["regs"], device="cpu")
    from prmers_tpu_torch.engine.factory import create_engine
    return create_engine(args["p"], args["regs"], device="cpu",
                         backend="sharded")


def engine(args):
    """An engine through a list of ops [name, *args]; "int" records
    get_int of a register, "state" a MeshEngine register's (digits,
    carries) as they stand, "raw" get_raw_tagged, "res64" psum_res64 of a
    ShardedEngine register, "ckpt" the checkpoint bytes, "save" and
    "load" parallel/shard_ckpt's save_sharded(dir, meta) and
    load_sharded(dir) (its meta recorded), "equal" is_equal of two
    registers, "type" the engine's class."""
    e = _engine(args)
    out = []
    for op, *a in args["ops"]:
        if op == "int":
            out.append(e.get_int(a[0]))
        elif op == "state":
            x, co = e.regs[a[0]][:2]
            out.append((_np(x), _np(co)))
        elif op == "raw":
            out.append(e.get_raw_tagged(a[0]))
        elif op == "res64":
            out.append(psum_res64(e.tables, e.regs[a[0]]))
        elif op == "ckpt":
            out.append(e.get_checkpoint())
        elif op == "save":
            shard_ckpt.save_sharded(e, *a)
        elif op == "load":
            out.append(shard_ckpt.load_sharded(e, a[0]))
        elif op == "type":
            out.append(type(e).__name__)
        elif op == "equal":
            out.append(e.is_equal(*a))
        else:
            getattr(e, op)(*a)
    return {"out": out, "calls": dict(tk.calls), "dist": dict(dist.counts)}


def prp(args):
    """The PRP/LL driver (modes/prp_ll.run_prp_or_ll) on the scenario's
    engine: its verdict and res64."""
    from prmers_tpu_torch.io.options import Options
    from prmers_tpu_torch.modes.prp_ll import run_prp_or_ll
    o = Options(exponent=args["p"], mode=args["mode"], backend="sharded",
                proof=False, save_dir=args["save_dir"])
    r = run_prp_or_ll(o, eng=_engine(args), log=lambda *a, **k: None)
    return {"prime": r.is_prime, "res64": r.res64}


def cli(args):
    """app.run on the CLI's arguments (the device the CPU): the result
    JSON and the log lines."""
    from prmers_tpu_torch import app
    from prmers_tpu_torch.io.cli import parse_args
    lines = []
    _r, j = app.run(parse_args(args["argv"]), device="cpu",
                    log=lambda *a: lines.append(" ".join(map(str, a))))
    return {"json": j, "log": lines}


SCENARIOS = {"moves": moves, "block_step": block_step, "engine": engine,
             "prp": prp, "cli": cli}


def main():
    scenario, init_file, out_dir, args = sys.argv[1:5]
    torch.set_num_threads(1)
    if init_file == "env":
        assert dist.init_from_env("cpu")
    else:
        dist.init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                  f"file://{init_file}", "cpu")
    rank = dist.rank()
    try:
        with open(args, "rb") as f:
            a = pickle.load(f)
        os.environ.update(a.get("env", {}))
        res = SCENARIOS[scenario](a)
    finally:
        dist.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
