"""Workload-aware arithmetic-path auto policy (gl64 vs fft3161).

Analog of the reference's Aevum/Marin auto policy
(reference: src/aevum/AutoPolicy.cpp:36-152 — per-workload transform-ratio
thresholds with AEVUM_AUTO_*_MAX_RATIO env overrides, decided per run in
engine::create_gpu, src/marin/gpu.cpp:52).

TPU adaptation: the reference's ratio thresholds encode "the two backends
have comparable per-word throughput, so the smaller transform wins".
That premise is measured false here, so measured rates decide: exact
tune entries when present, otherwise rates extrapolated from the nearest
tuned size of the same engine family (n*log n scaling). The per-workload
ratio thresholds and their env overrides still gate any switch to the
second path — the reference-parity surface — but never pick it alone.

fft3161 speed-role retirement — decided with ON-DEVICE data
(TPU v5e, 2026-08-20, prmers_tune.json; VERDICT r3 item 7):

    p        n_gl64 (engine)     iter/s | n_3161 (Engine3161)  iter/s
    9941     512    (JaxEngine)   610   | 256                   649
    216091   10240  (JaxEngine)   965   | 6144                  169
    756839   32768  (PallasEngine)1201  | 24576                 291
    3021377  163840 (JaxEngine)   1007  | 98304                 299

Only at trivially small sizes (p ~ 1e4, both paths XLA graphs, n below
the Pallas floor) does the smaller 3161 transform win — the reference
rule's regime. Everywhere the kernel sets are real, gl64 is 3.4-5.7x
faster despite transforms ~2x larger, matching PERF.md's op-count
analysis (on 16-bit-multiplier lanes every fft3161 component costs at
or above gl64 per payload bit). The second path's production role is
therefore CAPACITY (3*2^k/9*2^k sizes landing much closer to p, odd
small shapes), not speed; the measured-rates branch below realizes
exactly this — it picks fft3161 only where the numbers do.

Port: a copy of prmers_tpu/engine/policy.py with three changes.
_GL64_ENGINES names the port's Goldilocks engines (FourStepEngine,
TorchEngine, TorchRowEngine, NumpyEngine), the tune records being the
port's own (core/tune.py, prmers_torch_tune.json: the TPU rates of the
repository's prmers_tune.json never route the port). The eligibility
probe is the port's factory route (no PRMERS_NO_PALLAS, and
fourstep_engine.covers(plan, pipeline_from_env())) in place of
_pallas_eligible. A FourStepEngine rate
is an extrapolation donor only where that probe holds, as a PallasEngine
rate is in the reference. The module docstring's TPU table is the JAX
package's, kept as history; it is no measurement of the port.
"""

from __future__ import annotations

import dataclasses
import math
import os

# per-workload max n_3161/n_gl64 ratio at which the second path is viable
# (reference AutoPolicy profile_for :36-69)
THRESHOLDS = {
    "prp": 1.00,
    "ll": 1.00,
    "pm1_s1": 0.75,
    "pm1": 1.00,
    "ecm": 0.75,
    "generic": 1.00,
}

_GL64_ENGINES = ("FourStepEngine", "TorchEngine", "TorchRowEngine",
                 "NumpyEngine")


@dataclasses.dataclass
class ArithDecision:
    arith: str            # "gl64" | "fft3161"
    n_gl64: int
    n_3161: int
    ratio: float
    threshold: float
    ips_gl64: float
    ips_3161: float
    reason: str


def _best_rate(data: dict, n: int, engines) -> float:
    """Best measured rate for transform size n among the engine names."""
    return max((v for e, v in data.get(str(n), {}).items()
                if e in engines), default=0.0)


def _extrapolate_rate(data: dict, n: int, engines) -> tuple[float, int]:
    """(estimated ips at size n, donor size) from the nearest tuned size
    of the same engine family, scaled by the n*log2(n) work model; (0, 0)
    when the family has no entries at all."""
    best = (0.0, 0)
    best_dist = None
    for key, ent in data.items():
        try:
            m = int(key)
        except ValueError:
            continue
        if m < 8:
            continue
        rate = max((v for e, v in ent.items() if e in engines), default=0.0)
        if rate <= 0.0:
            continue
        dist = abs(math.log2(m / n))
        if best_dist is None or dist < best_dist:
            est = rate * (m * math.log2(m)) / (n * math.log2(n))
            best = (est, m)
            best_dist = dist
    return best


def decide_arith(p: int, workload: str = "generic",
                 save_dir: str = ".",
                 gl64_has_pallas: bool | None = None) -> ArithDecision:
    """Pick the arithmetic path. Decision order (reference:
    aevum_auto_decide, src/aevum/AutoPolicy.cpp:86-152):
      1. forced (PRMERS_ARITH / -arith),
      2. measured tune rates when both paths have exact entries,
      3. rates extrapolated from the nearest tuned sizes when both
         families have data (ratio threshold still gates the switch),
      4. otherwise gl64 — an fft3161 family with no measurement anywhere
         is never picked on the bare transform-size ratio (its premise,
         comparable per-word rates, is measured false here; run -tune).
    gl64_has_pallas overrides the eligibility probe (policy-boundary
    tests)."""
    from ..core.plan import transform_size
    from ..core import tune
    from ..ops.ntt2 import transform_size_3161

    n_gl = transform_size(p)
    n_2 = transform_size_3161(p)
    ratio = n_2 / n_gl
    thr = THRESHOLDS.get(workload, 1.0)
    # reference spellings (AEVUM_AUTO_*) accepted alongside PRMERS_AUTO_*
    # so a reference user's environment keeps working (reference:
    # CliParser.cpp help "Auto policy env": AEVUM_AUTO_MAX_RATIO or
    # AEVUM_AUTO_{PM1_STAGE1, PM1_STAGE2, ECM}_MAX_RATIO)
    ref_name = {"pm1_s1": "PM1_STAGE1", "pm1_s2": "PM1_STAGE2",
                "pm1": "PM1_STAGE2"}.get(workload, workload.upper())
    env = (os.environ.get(f"PRMERS_AUTO_{workload.upper()}_MAX_RATIO")
           or os.environ.get(f"AEVUM_AUTO_{ref_name}_MAX_RATIO")
           or os.environ.get("AEVUM_AUTO_MAX_RATIO"))
    if env:
        thr = float(env)

    if gl64_has_pallas is None:
        from ..core.plan import cached_plan
        from .factory import pipeline_from_env
        from .fourstep_engine import covers
        try:
            gl64_has_pallas = not os.environ.get("PRMERS_NO_PALLAS") and \
                covers(cached_plan(p), pipeline_from_env())
        except Exception:
            gl64_has_pallas = False

    data = tune.load(save_dir)
    # an exact-size tune entry is trusted whatever engine produced it; as
    # an extrapolation DONOR a FourStepEngine rate only transfers to
    # shapes the four-step kernel set can actually run
    gl_donors = _GL64_ENGINES if gl64_has_pallas else \
        tuple(e for e in _GL64_ENGINES if e != "FourStepEngine")
    ips_gl = _best_rate(data, n_gl, _GL64_ENGINES)
    ips_2 = _best_rate(data, n_2, ("Engine3161",))

    forced = os.environ.get("PRMERS_ARITH")
    if forced in ("gl64", "fft3161"):
        return ArithDecision(forced, n_gl, n_2, ratio, thr, ips_gl, ips_2,
                             "forced by PRMERS_ARITH")
    if ips_gl > 0 and ips_2 > 0:
        pick = "fft3161" if ips_2 > ips_gl else "gl64"
        return ArithDecision(pick, n_gl, n_2, ratio, thr, ips_gl, ips_2,
                             "measured rates (tune cache)")

    # extrapolate the missing side(s) from the nearest tuned sizes
    est_gl = ips_gl or _extrapolate_rate(data, n_gl, gl_donors)[0]
    est_2 = ips_2 or _extrapolate_rate(data, n_2, ("Engine3161",))[0]
    if est_gl > 0 and est_2 > 0:
        pick = "fft3161" if (est_2 > est_gl and ratio <= thr) else "gl64"
        return ArithDecision(pick, n_gl, n_2, ratio, thr, est_gl, est_2,
                             "extrapolated rates (tune cache, n*log n)")
    if est_2 > 0 and est_gl <= 0 and ratio <= thr:
        # only the fft3161 family has any measurement
        return ArithDecision("fft3161", n_gl, n_2, ratio, thr,
                             est_gl, est_2,
                             "fft3161 measured; gl64 family unmeasured")

    if est_2 <= 0 and ratio <= thr:
        # no fft3161 measurement anywhere: the reference's bare ratio
        # rule would pick the smaller transform here, but its premise
        # (comparable per-word rates, AutoPolicy.cpp:86) is measured
        # false for the XLA stand-in — gl64 holds until -tune shows
        # otherwise (rates: CPU 4-17x/word against fft3161; PERF.md's
        # op-count analysis says TPU is worse still)
        return ArithDecision("gl64", n_gl, n_2, ratio, thr, ips_gl,
                             ips_2,
                             f"ratio {ratio:.2f} within {thr:.2f} but "
                             "fft3161 unmeasured; run -tune to enable "
                             "the second path")
    if ratio > thr:
        return ArithDecision("gl64", n_gl, n_2, ratio, thr, ips_gl, ips_2,
                             f"ratio {ratio:.2f} exceeds {thr:.2f}")
    return ArithDecision("gl64", n_gl, n_2, ratio, thr, ips_gl, ips_2,
                         "gl64 carries the MXU kernel set")
