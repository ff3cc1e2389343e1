"""One rank of a CPU mesh test of the port (tests/test_torch_mesh.py).

    RANK=r WORLD_SIZE=s python tests/torch_mesh_worker.py SCENARIO \
        INIT_FILE OUT_DIR ARGS_PKL

joins a gloo group through the file:// rendezvous INIT_FILE (or, with
INIT_FILE "env", through dist.init_from_env and the JAX package's
PRMERS_COORDINATOR, PRMERS_NUM_PROCS and PRMERS_PROC_ID), runs the
scenario (its arguments a pickled dict in ARGS_PKL) on the CPU with one
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
from prmers_tpu_torch.parallel.mesh_engine import MeshEngine  # noqa: E402


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


def engine(args):
    """MeshEngine through a list of ops [name, *args]; "int" records
    get_int of a register, "state" a register's (digits, carries) as
    they stand, "ckpt" the checkpoint bytes."""
    e = MeshEngine(args["p"], args["regs"], device="cpu", n=args["n"])
    out = []
    for op, *a in args["ops"]:
        if op == "int":
            out.append(e.get_int(a[0]))
        elif op == "state":
            x, co = e.regs[a[0]][:2]
            out.append((_np(x), _np(co)))
        elif op == "ckpt":
            out.append(e.get_checkpoint())
        else:
            getattr(e, op)(*a)
    return {"out": out, "calls": dict(tk.calls), "dist": dict(dist.counts)}


SCENARIOS = {"moves": moves, "block_step": block_step, "engine": engine}


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
            res = SCENARIOS[scenario](pickle.load(f))
    finally:
        dist.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
