"""Engine factory of the port (counterpart of prmers_tpu/engine/factory.py,
its _create_engine at :131-202).

The backends (`backend=`, or PRMERS_BACKEND):
  * "auto" on one rank: the four-step kernel engine
    (engine/fourstep_engine.FourStepEngine) where it covers the plan
    (fourstep_engine.covers, the predicate of check_shape: n = 2^k with
    2^15 <= n <= 2^26, n = 5 * 2^k with 163840 <= n <= 5 * 2^25), and the
    any-size engine (engine/torch_engine) elsewhere, as the reference
    takes PallasEngine where _pallas_eligible holds and JaxEngine
    elsewhere (:151-157). The route is decided by that predicate before
    any engine is made; no refusal is caught and turned into another
    engine.
  * "pallas": the four-step engine, which raises NotImplementedError with
    the shape for a plan it does not cover.
  * "jax": the any-size engine, TorchEngine, or TorchRowEngine from n =
    ROW_MODE_MIN_N = 2^25 (:196-201).
  * "numpy": the host oracle, engine/np_engine.NumpyEngine (a copy of the
    reference's; it takes no device).
  * "sharded", and "auto" when the process group of parallel/dist has
    more than one rank (:68-84, :151-153): the mesh engine, chosen by
    PRMERS_SHARDED_IMPL as :177-189 do. "auto" (the default) takes
    parallel/mesh_engine.MeshEngine where it takes the shape and the
    pipeline (mesh_eligible with the pipeline: the row carry, s dividing
    R1 and R2, a plan of the four-step engine), and the XLA-form
    parallel/sharded.ShardedEngine, the any-shape fallback, everywhere
    else (n below 2^15, M756839 at s = 2 with R2 = 1, the block carry or
    the hybrid asked for); "pallas" always takes MeshEngine, whose shape
    refusal then raises; "xla" always takes ShardedEngine. The route is
    decided before an engine is made, so any other failure of MeshEngine
    raises as it is.
"pallas" and "jax" (after "auto" has chosen) page registers to the host
when reg_count exceeds engine/paged.device_reg_budget (the card's free
memory over the engine's bytes per register), as :158-176 do: the engine
gets the budget's count of slots and engine/paged.PagedEngine maps the
logical registers onto them; PRMERS_GPU_ALLOC_DIAG=1 prints the [ALLOC]
line, PRMERS_MAX_DEVICE_REGS and PRMERS_MEMLIM_MB set the budget.
PRMERS_NO_PALLAS sends every p to the any-size engine (:40, :73), on any
number of ranks.

The arithmetic (`arith=`, or PRMERS_ARITH, as factory.py:131-150 read
them): "gl64" gives the Goldilocks engines above; "fft3161" the paired
GF(M31^2) x GF(M61^2) NTT, engine/engine3161.Engine3161 (its numpy oracle
for "numpy", else on the device, on any backend, and never paged, as
factory.py:143-150); "auto" asks engine/policy.decide_arith(p, workload),
unless the backend is "numpy" or "sharded" (gl64-only surfaces). The
policy decides from the port's tune records (core/tune.py,
prmers_torch_tune.json in the working directory); with none it answers
gl64, so every route is then what it was before the policy. The same
records route one card to MeshEngine on a group of one rank where -tune
measured it more than 2% faster than FourStepEngine at the size and its
registers fit the card (_mesh_beats_fourstep, the reference's
_mesh_beats_pallas at :87-115). create_engine ends in
core/profile.maybe_wrap (:118-128), a ProfiledEngine under -profile.

The four-step engine's pipeline is the JAX package's default unless the
caller passes one, or the environment names one with the JAX package's
own switches, read here and nowhere else in the port: PRMERS_NO_ROWCARRY
(the block-carry pipeline, kernels.py:917), PRMERS_XLA_CARRY (the
canonical-digit hybrid, :987) and PRMERS_NO_CHAIN (no whole-chain kernel,
:1901). So `PRMERS_NO_ROWCARRY=1 python -m prmers_tpu_torch <p> -noproof`
and the bench reach those pipelines with no flag of their own. The mesh
engine takes only the row carry and raises under the other two.

The JAX package's other three pipeline switches, PRMERS_NO_MXU (the
unfolded passes with shift-twiddle butterflies, kernels.py:1453),
PRMERS_NO_WFOLD (the unfolded weights, :1473-1474) and PRMERS_NO_FUSE (no
fused C-transform, :1482 and pallas_engine.py:55), make create_engine
raise NotImplementedError: the pipelines they select give wrong results in
the reference (its get_int differs from big-int under the first two, the
folded C-transform tables apply the weights twice, fourstep.py:629-633 and
kernels.py:1619-1628, and the third ends in the assert at :1675), so the
port has no such pipeline. The unfolded passes themselves are ported
(ops/kernels.forward_r, inverse_r) and run through
tools/profile_passes, as in the reference.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import torchconf
from ..core.plan import cached_plan
from ..core.profile import maybe_wrap
from ..ops.fourstep import Pipeline
from ..parallel import dist
from ..parallel.mesh_engine import MeshEngine, mesh_eligible
from ..parallel.sharded import ShardedEngine
from .api import Engine
from .engine3161 import Engine3161
from .fourstep_engine import FourStepEngine, covers
from .np_engine import NumpyEngine
from .paged import PagedEngine, device_reg_budget
from .policy import decide_arith
from .torch_engine import ROW_MODE_MIN_N, TorchEngine, TorchRowEngine

BACKENDS = ("auto", "pallas", "sharded", "jax", "numpy")
ARITHS = ("auto", "gl64", "fft3161")
UNPORTED_SWITCHES = ("PRMERS_NO_MXU", "PRMERS_NO_WFOLD", "PRMERS_NO_FUSE")


def pipeline_from_env() -> Pipeline:
    """The Pipeline the JAX package's switches ask for (each on when set to
    a non-empty value, as the JAX package reads them)."""
    env = os.environ
    return Pipeline(rowcarry=not env.get("PRMERS_NO_ROWCARRY"),
                    xla_carry=bool(env.get("PRMERS_XLA_CARRY")),
                    chain=not env.get("PRMERS_NO_CHAIN"))


def _mesh_beats_fourstep(p: int, n: int, reg_count: int, device) -> bool:
    """Record-driven one-card routing (factory.py:87-115): MeshEngine on a
    group of one rank in place of FourStepEngine where the tune records
    measured it more than 2% faster at n, its registers fit the card (it
    has no paging) and it takes the shape. No record, no switch."""
    if os.environ.get("PRMERS_NO_MESH_SINGLE") or \
            os.environ.get("PRMERS_NO_ROWCARRY"):
        return False
    from ..core import tune
    mesh_rate = tune.lookup(n, "MeshEngine")
    if not mesh_rate or mesh_rate <= tune.lookup(n, "FourStepEngine") * 1.02:
        return False
    if reg_count > device_reg_budget(n, device=torchconf.device(device),
                                     backend="pallas"):
        return False
    return mesh_eligible(p, 1)


def create_engine(p: int, reg_count: int, device=None,
                  pipe: Pipeline | None = None,
                  backend: str | None = None, arith: str | None = None,
                  workload: str = "generic") -> Engine:
    return maybe_wrap(_create_engine(p, reg_count, device=device, pipe=pipe,
                                     backend=backend, arith=arith,
                                     workload=workload))


def _create_engine(p: int, reg_count: int, device=None,
                   pipe: Pipeline | None = None,
                   backend: str | None = None, arith: str | None = None,
                   workload: str = "generic") -> Engine:
    b = backend or os.environ.get("PRMERS_BACKEND") or "auto"
    if b not in BACKENDS:
        raise ValueError(f"unknown backend {b!r}")
    a = arith or os.environ.get("PRMERS_ARITH") or "auto"
    if a not in ARITHS:
        raise ValueError(f"unknown arithmetic {a!r}")
    if a == "auto":
        a = "gl64" if b in ("numpy", "sharded") else \
            decide_arith(p, workload).arith
    if a == "fft3161":
        if b == "numpy":
            return Engine3161(p, reg_count, xp=np)
        return Engine3161(p, reg_count, device=device)
    for name in UNPORTED_SWITCHES:
        if os.environ.get(name):
            raise NotImplementedError(
                f"{name} selects a pipeline prmers_tpu_torch does not have: "
                "the reference's pipelines under PRMERS_NO_MXU, "
                "PRMERS_NO_WFOLD and PRMERS_NO_FUSE give wrong results "
                "(ROADMAP queue 3); unset it. The unfolded passes run "
                "through python -m prmers_tpu_torch.tools.profile_passes")
    plan = cached_plan(p)
    if b == "numpy":
        return NumpyEngine(p, reg_count, plan=plan)
    if b == "auto":
        if os.environ.get("PRMERS_NO_PALLAS"):
            b = "jax"
        elif dist.process_count() > 1:
            b = "sharded"
        else:
            pipe = pipeline_from_env() if pipe is None else pipe
            b = "pallas" if covers(plan, pipe) else "jax"
            if b == "pallas" and _mesh_beats_fourstep(p, plan.n, reg_count,
                                                      device):
                b = "sharded"
    if b in ("pallas", "jax"):
        # more registers than the card holds spill to the host through the
        # LRU paging wrapper (factory.py:158-176)
        device = torchconf.device(device)
        budget = device_reg_budget(plan.n, device=device, backend=b)
        if os.environ.get("PRMERS_GPU_ALLOC_DIAG") == "1":
            gib = reg_count * plan.n * 8 / (1 << 30)
            print(f"[ALLOC] logical regs={reg_count} slab={gib:.2f} GiB "
                  f"device budget={budget} regs"
                  f"{' -> host-paged LRU' if reg_count > budget else ''}",
                  file=sys.stderr)
        if reg_count > budget:
            inner = _create_engine(p, budget, device=device, pipe=pipe,
                                   backend=b, arith="gl64")
            return PagedEngine(inner, reg_count)
    if b == "jax":
        cls = TorchRowEngine if plan.n >= ROW_MODE_MIN_N else TorchEngine
        return cls(p, reg_count, plan=plan, device=device)
    pipe = pipeline_from_env() if pipe is None else pipe
    if b == "sharded":
        impl = os.environ.get("PRMERS_SHARDED_IMPL", "auto")
        if impl == "pallas" or (impl != "xla" and
                                mesh_eligible(p, pipe=pipe)):
            return MeshEngine(p, reg_count, device=device, pipe=pipe)
        return ShardedEngine(p, reg_count, device=device)
    return FourStepEngine(p, reg_count, plan=plan, device=device, pipe=pipe)
