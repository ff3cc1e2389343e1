"""Engine factory of the port (counterpart of prmers_tpu/engine/factory.py).

It hands out the four-step kernel engine for the shapes the port covers
(engine/fourstep_engine.check_shape) and raises NotImplementedError with
the shape for any other: there is no fallback to another engine or to the
JAX package.

The pipeline is the JAX package's default unless the caller passes one,
or the environment names one with the JAX package's own switches, read
here and nowhere else in the port: PRMERS_NO_ROWCARRY (the block-carry
pipeline, kernels.py:917), PRMERS_XLA_CARRY (the canonical-digit hybrid,
:987) and PRMERS_NO_CHAIN (no whole-chain kernel, :1901). So
`PRMERS_NO_ROWCARRY=1 python -m prmers_tpu_torch <p> -noproof` and the
bench reach those pipelines with no flag of their own.
"""

from __future__ import annotations

import os

from ..core.plan import cached_plan
from ..ops.fourstep import Pipeline
from .fourstep_engine import FourStepEngine


def pipeline_from_env() -> Pipeline:
    """The Pipeline the JAX package's switches ask for (each on when set to
    a non-empty value, as the JAX package reads them)."""
    env = os.environ
    return Pipeline(rowcarry=not env.get("PRMERS_NO_ROWCARRY"),
                    xla_carry=bool(env.get("PRMERS_XLA_CARRY")),
                    chain=not env.get("PRMERS_NO_CHAIN"))


def create_engine(p: int, reg_count: int, device=None,
                  pipe: Pipeline | None = None) -> FourStepEngine:
    return FourStepEngine(p, reg_count, plan=cached_plan(p), device=device,
                          pipe=pipeline_from_env() if pipe is None else pipe)
