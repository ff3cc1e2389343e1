"""Engine factory of the port (counterpart of prmers_tpu/engine/factory.py).

It hands out the four-step kernel engine for the shapes the port covers
(engine/fourstep_engine.check_shape) and raises NotImplementedError with
the shape for any other: there is no fallback to another engine or to the
JAX package. The backend "sharded" (`backend=`, or PRMERS_BACKEND) gives
the mesh engine (parallel/mesh_engine.MeshEngine) over the process group
of parallel/dist, and so does "auto" when that group has more than one
rank (factory.py:68-84, 151-153); a shape the mesh does not take raises
ValueError with the shape, for there is no XLA mesh engine to fall back
on. "pallas" is the four-step engine as "auto" is on one rank; "jax" and
"numpy" name engines the port does not have.

The arithmetic (`arith=`, or PRMERS_ARITH, as factory.py:135 reads them)
is Goldilocks: "auto" and "gl64" give the engines above, and "fft3161",
the paired GF(M31^2) x GF(M61^2) NTT of the JAX package's Engine3161, is
not ported and raises NotImplementedError. "auto" needs no tune record to
decide, since without one the JAX's policy picks gl64 too
(policy.py:170-186), so `workload=` (what the JAX's policy weighs) is
taken for the callers' sake and changes nothing.

The pipeline is the JAX package's default unless the caller passes one,
or the environment names one with the JAX package's own switches, read
here and nowhere else in the port: PRMERS_NO_ROWCARRY (the block-carry
pipeline, kernels.py:917), PRMERS_XLA_CARRY (the canonical-digit hybrid,
:987) and PRMERS_NO_CHAIN (no whole-chain kernel, :1901). So
`PRMERS_NO_ROWCARRY=1 python -m prmers_tpu_torch <p> -noproof` and the
bench reach those pipelines with no flag of their own. The mesh engine
takes only the row carry and raises under the other two.

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

Two more switches name engines the port does not have yet, and make
create_engine raise NotImplementedError in the same way: PRMERS_NO_PALLAS
(the JAX package's XLA engines in place of its kernel engines,
factory.py:40 and :73) and PRMERS_SHARDED_IMPL=xla (the XLA mesh engine,
:74 and :180). Neither is ported (ROADMAP queue 1), so a run under them
stops rather than take the kernel engine they turned away from.
"""

from __future__ import annotations

import os

from ..core.plan import cached_plan
from ..ops.fourstep import Pipeline
from ..parallel import dist
from ..parallel.mesh_engine import MeshEngine
from .api import Engine
from .fourstep_engine import FourStepEngine

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


def create_engine(p: int, reg_count: int, device=None,
                  pipe: Pipeline | None = None,
                  backend: str | None = None, arith: str | None = None,
                  workload: str = "generic") -> Engine:
    b = backend or os.environ.get("PRMERS_BACKEND") or "auto"
    if b not in BACKENDS:
        raise ValueError(f"unknown backend {b!r}")
    a = arith or os.environ.get("PRMERS_ARITH") or "auto"
    if a not in ARITHS:
        raise ValueError(f"unknown arithmetic {a!r}")
    for name in (b, a):
        if name in ("jax", "numpy", "fft3161"):
            raise NotImplementedError(f"the {name!r} engine is not ported "
                                      "to prmers_tpu_torch")
    for name in UNPORTED_SWITCHES:
        if os.environ.get(name):
            raise NotImplementedError(
                f"{name} selects a pipeline prmers_tpu_torch does not have: "
                "the reference's pipelines under PRMERS_NO_MXU, "
                "PRMERS_NO_WFOLD and PRMERS_NO_FUSE give wrong results "
                "(ROADMAP queue 3); unset it. The unfolded passes run "
                "through python -m prmers_tpu_torch.tools.profile_passes")
    if os.environ.get("PRMERS_NO_PALLAS"):
        raise NotImplementedError(
            "PRMERS_NO_PALLAS selects the JAX package's XLA engines, which "
            "are not ported to prmers_tpu_torch; unset it")
    if os.environ.get("PRMERS_SHARDED_IMPL") == "xla":
        raise NotImplementedError(
            "PRMERS_SHARDED_IMPL=xla selects the JAX package's XLA mesh "
            "engine, which is not ported to prmers_tpu_torch; unset it")
    pipe = pipeline_from_env() if pipe is None else pipe
    if b == "sharded" or (b == "auto" and dist.process_count() > 1):
        return MeshEngine(p, reg_count, device=device, pipe=pipe)
    return FourStepEngine(p, reg_count, plan=cached_plan(p), device=device,
                          pipe=pipe)
