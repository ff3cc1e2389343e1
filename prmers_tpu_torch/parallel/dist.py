"""The process group of the mesh and its collectives, over torch.distributed.

Counterpart of prmers_tpu/parallel/dist.py, and of the collectives that
sharded_pallas.py and mesh_engine.py call inside shard_map. One process
runs per card (NCCL), or per CPU rank in the tests (gloo). A register of
(R1, R2, C) digits is r1-sharded at rest: rank r holds rows r*R1/s to
(r+1)*R1/s - 1, a contiguous run of digits (the digit order is r1-major),
so the carry ring is one hop.

  init_from_env()        joins the group that torchrun (RANK, WORLD_SIZE,
                         LOCAL_RANK, MASTER_ADDR/PORT) or the JAX package's
                         variables (PRMERS_COORDINATOR, PRMERS_NUM_PROCS,
                         PRMERS_PROC_ID, dist.py:29-43) describe; init()
                         joins one given outright (the tests: file://)
  is_primary, rank, process_count, barrier, device, shutdown
  global_gather(x)       the r1-sharded tensor, whole, on every rank
  put_global(full)       this rank's rows of a host value all ranks hold
  to_r2_sharded(x)       lax.all_to_all(x, LIMB, 1, 0, tiled=True):
                         (R1/s, R2, ...) -> (R1, R2/s, ...)
  to_r1_sharded(y)       the reverse move
  ring_prev(last)        the ppermute to rank + 1 (sharded_pallas.py:166):
                         returns what rank - 1 sent
  all_gather_scalars(v)  (k,) per rank -> (s, k), for the carry ring's
                         lookahead (mesh_engine.py:117-118)

Without a group, or in a group of one, the moves return their input and
the ring its own `last` (NCCL refuses a send to the sender's own rank), so
s = 1 runs no collective. Every collective is synchronous on the current
stream (async_op=False; the point-to-point requests are waited), so a
kernel launched next on that stream reads its output. `counts` counts the
collectives that ran; with time_collectives(True) each one on a card is
also timed by CUDA events on the current stream (collective_ms()).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as tdist

from .. import torchconf

COLLECTIVES = ("to_r2", "to_r1", "ring_prev", "all_gather")
counts = {name: 0 for name in COLLECTIVES}
_state: dict = {"device": None, "events": None}


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def init(rank: int, world_size: int, init_method: str,
         device=None) -> torch.device:
    """Join a group of world_size ranks as rank: NCCL for a CUDA device,
    gloo for the CPU. Returns the rank's device."""
    dev = torchconf.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=world_size,
        device_id=dev if dev.type == "cuda" else None)
    _state["device"] = dev
    return dev


def init_from_env(device=None) -> bool:
    """Join the group the environment describes; returns True if there is
    one (a group of one under `torchrun --nproc_per_node=1` too). The
    device is cuda:LOCAL_RANK unless the caller passes one; without
    LOCAL_RANK (the JAX package's variables) it is cuda:RANK, and a group
    larger than this host's cards raises, for a group across hosts is not
    ported."""
    if initialized():
        return True
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        method = "env://"
    elif env.get("PRMERS_COORDINATOR") and \
            int(env.get("PRMERS_NUM_PROCS", "1")) > 1:
        rank = int(env.get("PRMERS_PROC_ID", "0"))
        world = int(env["PRMERS_NUM_PROCS"])
        method = f"tcp://{env['PRMERS_COORDINATOR']}"
    else:
        return False
    if device is None:
        if "LOCAL_RANK" not in env and world > torch.cuda.device_count():
            raise ValueError(
                f"{world} ranks without LOCAL_RANK on a host with "
                f"{torch.cuda.device_count()} cards: a group across hosts "
                "is not ported (set LOCAL_RANK, or run one host's ranks)")
        device = f"cuda:{env.get('LOCAL_RANK', rank)}"
    init(rank, world, method, device)
    return True


def shutdown() -> None:
    if initialized():
        tdist.destroy_process_group()
    _state["device"] = None


def rank() -> int:
    return tdist.get_rank() if initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    return rank() == 0


def device(default=None) -> torch.device:
    """The group's device, or torchconf's choice for `default` outside a
    group."""
    if initialized() and _state["device"] is not None:
        return _state["device"]
    return torchconf.device(default)


def barrier() -> None:
    if process_count() > 1:
        tdist.barrier()


def time_collectives(on: bool) -> None:
    _state["events"] = [] if on else None


def collective_ms() -> dict:
    """Milliseconds spent in each collective on the current stream since
    time_collectives(True) (CUDA tensors only)."""
    out = {name: 0.0 for name in COLLECTIVES}
    events = _state["events"] or []
    if events:
        torch.cuda.synchronize()
    for name, e0, e1 in events:
        out[name] += e0.elapsed_time(e1)
    return out


@contextlib.contextmanager
def _run(name: str, x: torch.Tensor):
    counts[name] += 1
    events = _state["events"]
    if events is None or x.device.type != "cuda":
        yield
        return
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    yield
    e1.record()
    events.append((name, e0, e1))


def global_gather(x: torch.Tensor) -> torch.Tensor:
    """The r1-sharded x of every rank, concatenated along axis 0."""
    s = process_count()
    if s == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(s)]
    tdist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def put_global(full: np.ndarray) -> np.ndarray:
    """This rank's part along axis 0 of a host value every rank holds
    whole (dist.py:79-89)."""
    m = full.shape[0] // process_count()
    r = rank()
    return np.ascontiguousarray(full[r * m:(r + 1) * m])


def to_r2_sharded(x: torch.Tensor) -> torch.Tensor:
    """(R1/s, R2, ...) r1-sharded -> (R1, R2/s, ...) r2-sharded: rank r
    gets the r2 slice r of every rank's rows, stacked in rank order."""
    s = process_count()
    if s == 1:
        return x
    R1s, R2 = x.shape[:2]
    rest = tuple(x.shape[2:])
    send = x.reshape((R1s, s, R2 // s) + rest).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    with _run("to_r2", x):
        tdist.all_to_all_single(recv, send)
    return recv.reshape((s * R1s, R2 // s) + rest)


def to_r1_sharded(y: torch.Tensor) -> torch.Tensor:
    """(R1, R2/s, ...) r2-sharded -> (R1/s, R2, ...) r1-sharded."""
    s = process_count()
    if s == 1:
        return y
    R1, R2s = y.shape[:2]
    rest = tuple(y.shape[2:])
    send = y.contiguous()
    recv = torch.empty_like(send)
    with _run("to_r1", y):
        tdist.all_to_all_single(recv, send)
    recv = recv.reshape((s, R1 // s, R2s) + rest).transpose(0, 1)
    return recv.reshape((R1 // s, s * R2s) + rest).contiguous()


def ring_prev(last: torch.Tensor) -> torch.Tensor:
    """Send `last` to rank + 1 and return what rank - 1 sent (the last
    rank's reaches rank 0: on the carry ring that wrap is the mod-M_p
    fold)."""
    s = process_count()
    if s == 1:
        return last
    r = rank()
    recv = torch.empty_like(last)
    ops = [tdist.P2POp(tdist.isend, last.contiguous(), (r + 1) % s),
           tdist.P2POp(tdist.irecv, recv, (r - 1) % s)]
    with _run("ring_prev", last):
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    return recv


def all_gather_scalars(v: torch.Tensor) -> torch.Tensor:
    """(k,) on each rank -> (s, k), row j from rank j."""
    s = process_count()
    if s == 1:
        return v[None]
    parts = [torch.empty_like(v) for _ in range(s)]
    with _run("all_gather", v):
        tdist.all_gather(parts, v.contiguous())
    return torch.stack(parts)
