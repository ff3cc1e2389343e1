"""Engine factory of the port (counterpart of prmers_tpu/engine/factory.py).

It hands out the four-step kernel engine for the shapes the port covers
(engine/fourstep_engine.check_shape) and raises NotImplementedError with
the shape for any other: there is no fallback to another engine or to the
JAX package.
"""

from __future__ import annotations

from ..core.plan import cached_plan
from .fourstep_engine import FourStepEngine


def create_engine(p: int, reg_count: int, device=None) -> FourStepEngine:
    return FourStepEngine(p, reg_count, plan=cached_plan(p), device=device)
