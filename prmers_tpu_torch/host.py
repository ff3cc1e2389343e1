"""The host-side code the port shares with prmers_tpu.

These modules of the JAX package import no jax, so the port imports them
rather than copying them: the plan and digit widths, the field constants,
digit packing, GMP big-int, the Engine API, the CLI, the result JSON and
the PRP/LL driver (with its checkpoints, progress and Gerbicz-Li checks).
The port and chip_smoke.py reach prmers_tpu only through this module, so
it is the one list of what is shared; tests/test_torch_jaxfree.py holds
the list free of jax.
"""

from prmers_tpu.core import field
from prmers_tpu.core.plan import Plan, build_plan, cached_plan
from prmers_tpu.engine.api import Engine, Reg
from prmers_tpu.io import json_out
from prmers_tpu.io.cli import parse_args
from prmers_tpu.modes.prp_ll import run_prp_or_ll
from prmers_tpu.utils import digits, gmp

__all__ = ["field", "Plan", "build_plan", "cached_plan", "Engine", "Reg",
           "json_out", "parse_args", "run_prp_or_ll", "digits", "gmp"]
