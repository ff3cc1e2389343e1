"""Entry points of the port: a one-card compile check and a multi-card dry
run (the twin of the repository root's __graft_entry__.py, which holds the
JAX package's).

  entry(device=None)
      (fn, example_args): fn(regs, src, a) is one any-size squaring
      (engine/torch_engine.TorchEngine.square_mul) of register src of an
      (8, n) slab times a, at p = 9941 (n = 512), returning the slab;
      example_args hold 3 in register 0, src 0 and a 1, so fn(*args)
      leaves 9 there. On the card unless device="cpu".
  dryrun_multichip(n_ranks, device=None)
      the root file's three sections on a group of n_ranks (one process
      per card, NCCL; gloo with device="cpu"), each against big-int:
        1. parallel/sharded.ShardedSquareStep at p = 9941: a chain of
           x^2 * a with a = 1, 3, 1 from 3, then psum_res64 of the result;
        2. parallel/sharded_kernels.ShardedStep (the kernels' row-carry
           mesh step) at n = 2^19: three squarings, then the x3 step;
        3. parallel/mesh_engine.MeshEngine at n = 2^19: a chain and the x3
           step, a sub (the carry ring), a checkpoint, a divergent
           squaring, the restore and the replay.
      Called outside a group it starts n_ranks processes of this module
      (`python -m prmers_tpu_torch.graft_entry dryrun DEVICE`, torchrun's
      variables on a free local port) and raises if one fails; called on
      a group of n_ranks (under torchrun) it runs the sections there.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import torch

P_ENTRY = 9941          # the golden-test exponent (n = 512)
N2 = 1 << 19


def entry(device=None):
    """(fn, example_args) for one any-size PRP squaring at p = 9941."""
    from .engine.torch_engine import TorchEngine
    from .ops import gl64 as gl
    from .utils import digits as dg

    eng = TorchEngine(P_ENTRY, 8, device=device, graphs=False)

    def fn(regs, src, a):
        eng.regs = regs
        eng.square_mul(int(src), int(a))
        return eng.regs

    regs = torch.zeros((8, eng.get_size()), dtype=torch.int64,
                       device=eng.device)
    regs[0] = gl.from_numpy_u64(dg.int_to_digits(3, eng.widths), eng.device)
    return fn, (regs, 0, 1)


def _dryrun(log=print) -> None:
    """The three sections on the group this process belongs to."""
    from .core.plan import build_plan, cached_plan
    from .ops import gl64 as gl
    from .parallel import dist
    from .parallel.mesh_engine import MeshEngine
    from .parallel.sharded import ShardedSquareStep, psum_res64
    from .parallel.sharded_kernels import ShardedStep
    from .utils import digits as dg

    t0 = time.monotonic()
    s = dist.process_count()

    def el():
        return f"[t={time.monotonic() - t0:.0f}s]"

    # 1. the XLA-form mesh squaring: 4 all-to-alls and the carry ring
    p = P_ENTRY
    plan = cached_plan(p)
    mp = (1 << p) - 1
    step = ShardedSquareStep(p, 2)
    step.regs[0] = gl.from_numpy_u64(dist.put_global(
        dg.int_to_digits(3, plan.widths)), step.tables.device)
    want = 3
    for a in (1, 3, 1):
        out = step.step(0, a)
        want = want * want * a % mp
    got = dg.digits_to_int(gl.to_numpy_u64(dist.global_gather(out[0])),
                           plan.widths)
    assert got == want, f"sharded squaring produced {got}, expected {want}"
    assert psum_res64(step.tables, out[0]) == want & 0xFFFFFFFFFFFFFFFF
    log(f"dryrun_multichip({s}): sharded square chain + psum res64 OK "
        f"{el()}")

    # 2. the kernels' mesh step, x^2 * a included
    p2 = int(N2 * 16.2) | 1
    mp2 = (1 << p2) - 1
    plan2 = build_plan(p2, n=N2)
    st = ShardedStep(p2, n=N2)
    st.set_digits(dg.int_to_digits(3, plan2.widths))
    st.step(3)
    assert st.get_int() == pow(3, 8, mp2), "kernel mesh chain mismatch"
    st.step(1, a=3)
    assert st.get_int() == pow(3, 16, mp2) * 3 % mp2, \
        "kernel mesh x3 step mismatch"
    log(f"dryrun_multichip({s}): kernel mesh step (4 all-to-alls + carry "
        f"ring, incl. x^2*a) OK at n={N2} {el()}")

    # 3. the production mesh engine: chains, a linear op, a checkpoint
    # round trip and its replay
    B = 4
    eng = MeshEngine(p2, 4, n=N2)
    eng.set(0, 3)
    eng.copy(2, 0)
    eng.square_mul_seq(0, [1] * B)
    eng.square_mul(0, 3)
    x = pow(3, 2 << B, mp2) * 3 % mp2
    assert eng.get_int(0) == x, "mesh engine chain mismatch"
    eng.sub(0, 2)
    assert eng.get_int(0) == (x - 2) % mp2, "mesh engine linear mismatch"
    blob = eng.get_checkpoint()
    eng.square_mul(2, 1)                  # diverge past the checkpoint
    eng.set_checkpoint(blob)
    eng.square_mul_seq(2, [1] * B)        # replay from the last good copy
    assert eng.get_int(2) == pow(3, 1 << B, mp2), \
        "mesh engine checkpoint replay mismatch"
    assert eng.get_int(0) == (x - 2) % mp2, \
        "mesh engine checkpoint state mismatch"
    log(f"dryrun_multichip({s}): MeshEngine (chains + linear + ckpt "
        f"replay) OK {el()}")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dryrun_multichip(n_ranks: int, device=None) -> None:
    """The dry run on a group of n_ranks (see the module docstring)."""
    from .parallel import dist
    if dist.initialized():
        assert dist.process_count() == n_ranks, \
            f"the group has {dist.process_count()} ranks, not {n_ranks}"
        _dryrun(log=lambda *a: dist.is_primary() and print(*a, flush=True))
        return
    kind = "cpu" if str(device).startswith("cpu") else "cuda"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(WORLD_SIZE=str(n_ranks), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join(
                   [root] + [x for x in [env.get("PYTHONPATH")] if x]))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if kind == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "prmers_tpu_torch.graft_entry", "dryrun",
         kind],
        env=dict(env, RANK=str(r), **({"LOCAL_RANK": str(r)}
                                      if kind == "cuda" else {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_ranks)]
    try:
        outs = [pr.communicate(timeout=900)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        if pr.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} of {n_ranks} failed "
                               f"({pr.returncode}):\n{out[-4000:]}")
    print(outs[0], end="", flush=True)


def _rank_main(kind: str) -> int:
    from .parallel import dist
    if kind == "cpu":
        torch.set_num_threads(1)
    dist.init_from_env("cpu" if kind == "cpu" else None)
    try:
        _dryrun(log=lambda *a: dist.is_primary() and print(*a, flush=True))
    finally:
        dist.shutdown()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dryrun"]:
        sys.exit(_rank_main(sys.argv[2]))
    print(__doc__)
    sys.exit(2)
