"""ECM factoring of Mersenne numbers — Montgomery curves with Suyama
parametrization: x-only ladder stage 1, BSGS cross-product stage 2.

Algorithm parity with the reference ECM drivers
(reference: src/modes/RunEcm.cpp:185-520, per-curve deterministic splitmix64
seeds :205-218, ecm_result shape :259-285; the 51-register twisted-Edwards
default of RunEcmTwistedEdwards.cpp:834 is the planned fast path — this
module is the mathematically classic Montgomery formulation expressed over
the Engine register API).

Stage 1: on B*y^2 = x^3 + A*x^2 + x with Suyama's sigma: u = s^2-5, v = 4s,
x0 = u^3/v^3, a24 = (A+2)/4 = (v-u)^3 (3u+v) / (16 u^3 v), all host-side
mod N = M_p (a failed inversion already yields a factor). The Montgomery
ladder computes [k](x0:1) for k = prod of prime powers <= B1; a prime
factor divides gcd(Z, N) iff the curve order over it divides k.

Stage 2: S = [k]P. For q = mD - j (gcd(j, D) = 1): q*S vanishes mod f iff
x([mD]S) = x([j]S), i.e. f | X_m Z_j - X_j Z_m; the product of these
cross-terms over primes in (B1, B2] goes to a gcd.

Port: a copy of prmers_tpu/modes/ecm.py. Its changes: `device=` runs
from run_ecm (and _backtrack_single) into create_engine, as in P-1; and
_run_ecm_batch, whose BatchJaxEngine is not yet ported, logs where the
reference would batch that the classic per-curve loop runs, and returns
False (the reference's PRMERS_ECM_NO_BATCH path).
"""

from __future__ import annotations

import dataclasses
import math
import os

from ..utils import gmp
import time

from ..engine.api import Engine
from ..engine.factory import create_engine
from ..io.options import Options
from ..utils import primes as pr


def splitmix64(x: int) -> int:
    """Deterministic per-curve seed mix (reference: RunEcm.cpp:205-218)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


@dataclasses.dataclass
class EcmResult:
    p: int
    b1: int
    b2: int
    curves: int
    factor: int = 0
    factor_sigma: int = 0
    factor_curve: int = -1
    stage: int = 0
    elapsed: float = 0.0
    # every factor found when -ecm-continue-after-factor keeps the
    # remaining curves running (first one mirrored in .factor)
    factors: tuple[int, ...] = ()


class _FactorFound(Exception):
    def __init__(self, f: int):
        self.f = f


def _inv_or_factor(a: int, n: int) -> int:
    a %= n
    g = gmp.gcd(a, n)
    if g != 1:
        raise _FactorFound(g if g != n else 0)
    return gmp.invert(a, n)


def suyama_curve(sigma: int, n: int) -> tuple[int, int]:
    """(x0, a24) of the Suyama curve for parameter sigma, mod n."""
    u = (sigma * sigma - 5) % n
    v = (4 * sigma) % n
    x0 = gmp.mulmod(gmp.powmod(u, 3, n), _inv_or_factor(gmp.powmod(v, 3, n), n), n)
    a24 = gmp.mulmod(gmp.powmod((v - u) % n, 3, n), 3 * u + v, n)
    a24 = gmp.mulmod(a24, _inv_or_factor(gmp.mulmod(16 * u, gmp.mulmod(u, u * v % n, n), n), n), n)
    return x0, a24


def torsion8_curve(seed: int, n: int) -> tuple[int, int, int]:
    """(x0, a24, param) of a Montgomery curve with rational 8-torsion
    (reference: the picked_mode==2 construction, src/modes/RunEcm.cpp:
    ~1530-1560): random a, v = 4a^2/(48a^2 - 1),
    A = -((4v+1)^2 + 16v), x0 = 4v + 1."""
    a = splitmix64(seed ^ 0xD1E2C3B4A5968775) % n
    if a < 2:
        a += 2
    a2 = a * a % n
    v = 4 * a2 % n * _inv_or_factor(48 * a2 - 1, n) % n
    fourv1 = (4 * v + 1) % n
    A = (-(fourv1 * fourv1 + 16 * v)) % n
    a24 = (A + 2) * _inv_or_factor(4, n) % n
    return fourv1, a24, a


def _ec_mul_4x(k: int, n: int) -> tuple[int, int] | None:
    """k * (4, 8) on y^2 = x^3 + 4x mod n (affine short Weierstrass);
    None at infinity; a non-invertible denominator raises _FactorFound
    (reference: EC_mod4, src/modes/RunEcmTwistedEdwards.cpp:723-807)."""
    def dbl(P):
        if P is None:
            return None
        x, y = P
        if y % n == 0:
            return None
        lam = (3 * x * x + 4) * _inv_or_factor(2 * y, n) % n
        x3 = (lam * lam - 2 * x) % n
        return x3, (lam * (x - x3) - y) % n

    def add(P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        if P[0] % n == Q[0] % n:
            if (P[1] + Q[1]) % n == 0:
                return None
            return dbl(P)
        lam = (Q[1] - P[1]) * _inv_or_factor(Q[0] - P[0], n) % n
        x3 = (lam * lam - P[0] - Q[0]) % n
        return x3, (lam * (P[0] - x3) - P[1]) % n

    P0 = (4, 8)
    P = P0
    for b in range(k.bit_length() - 2, -1, -1):
        P = dbl(P)
        if (k >> b) & 1:
            P = add(P, P0)
        if P is None:
            return None
    return P


def torsion16_mont_curve(seed: int, n: int) -> tuple[int, int, int]:
    """(x0, a24, k) of a Montgomery curve with rational 16-torsion
    (reference: picked_mode==1, src/modes/RunEcm.cpp:~1480-1528):
    (s, t) = k*(4, 8) on y^2 = x^3 + 4x, alpha = (t+8)/(s-4),
    r = (8+2a)/(8-a^2), A = (8r^4-16r^3+16r^2-8r+1)/(4r^2),
    x0 = 1/2 - r^2."""
    for tries in range(128):
        k = splitmix64(seed ^ 0x544F4D31 ^ tries) | 1
        if k < 3:
            k += 2
        st = _ec_mul_4x(k, n)
        if st is None:
            continue
        s, t = st
        alpha = (t + 8) * _inv_or_factor(s - 4, n) % n
        a2 = alpha * alpha % n
        r = (8 + 2 * alpha) * _inv_or_factor(8 - a2, n) % n
        r2 = r * r % n
        r3 = r2 * r % n
        r4 = r2 * r2 % n
        A = ((8 * r4 - 16 * r3 + 16 * r2 - 8 * r + 1)
             * _inv_or_factor(4 * r2, n)) % n
        a24 = (A + 2) * _inv_or_factor(4, n) % n
        x0 = (_inv_or_factor(2, n) - r2) % n
        if x0 == 0:
            continue
        return x0, a24, k
    raise _FactorFound(0)


# fixed register map (scratch + curve state); baby tables allocate upward
(XA, ZA, XB, ZB, T1, T2, T3, T4, M1, RA24, RX0, RACC, RGX, RGZ, RPX, RPZ,
 GDX, GDZ, PRVX, PRVZ) = range(20)
ECM_BASE_REGS = 20


class MontOps:
    """x-only Montgomery arithmetic over engine registers. Products go
    through the M1 multiplicand scratch; set_multiplicand captures the
    operand, so output aliasing is unrestricted."""

    def __init__(self, eng: Engine):
        self.e = eng

    def mul_into(self, dst: int, a: int, b: int):
        e = self.e
        e.set_multiplicand(M1, b)
        if dst != a:
            e.copy(dst, a)
        e.mul(dst, M1)

    def sqr_into(self, dst: int, a: int):
        e = self.e
        if dst != a:
            e.copy(dst, a)
        e.square_mul(dst)

    def xdbl(self, xo: int, zo: int, xi: int, zi: int):
        """(xo:zo) = 2*(xi:zi). Clobbers T1..T4."""
        e = self.e
        e.copy(T1, xi)
        e.add(T1, zi)
        self.sqr_into(T1, T1)           # (x+z)^2
        e.copy(T2, xi)
        e.sub_reg(T2, zi)
        self.sqr_into(T2, T2)           # (x-z)^2
        e.copy(T3, T1)
        e.sub_reg(T3, T2)               # 4xz
        self.mul_into(xo, T1, T2)       # x' = (x+z)^2 (x-z)^2
        e.copy(T4, T3)
        self.mul_into(T4, T4, RA24)     # a24 * 4xz
        e.add(T4, T2)                   # (x-z)^2 + a24*4xz
        self.mul_into(zo, T3, T4)       # z' = 4xz * (...)

    def xadd(self, xo: int, zo: int, xa: int, za: int, xb: int, zb: int,
             xd: int, zd: int | None):
        """(xo:zo) = (xa:za) + (xb:zb), difference (xd:zd); zd None = 1.
        Clobbers T1..T4; outputs written last so aliasing is safe."""
        e = self.e
        e.copy(T1, xa)
        e.sub_reg(T1, za)               # da
        e.copy(T2, xb)
        e.add(T2, zb)                   # sb
        self.mul_into(T1, T1, T2)       # da*sb
        e.copy(T2, xa)
        e.add(T2, za)                   # sa
        e.copy(T3, xb)
        e.sub_reg(T3, zb)               # db
        self.mul_into(T2, T2, T3)       # sa*db
        e.copy(T3, T1)
        e.add(T3, T2)
        self.sqr_into(T3, T3)           # (da*sb + sa*db)^2
        e.copy(T4, T1)
        e.sub_reg(T4, T2)
        self.sqr_into(T4, T4)           # (da*sb - sa*db)^2
        if zd is not None:
            self.mul_into(T3, T3, zd)
        self.mul_into(T4, T4, xd)
        e.copy(xo, T3)
        e.copy(zo, T4)

    def ladder(self, k: int):
        """(XA:ZA) = [k](RX0:1), k >= 1."""
        e = self.e
        e.copy(XA, RX0)
        e.set(ZA, 1)
        if k == 1:
            return
        self.xdbl(XB, ZB, XA, ZA)       # B = 2P
        for i in range(k.bit_length() - 2, -1, -1):
            if (k >> i) & 1:
                # (A, B) <- (A+B, 2B)
                self.xadd(XA, ZA, XA, ZA, XB, ZB, RX0, None)
                self.xdbl(XB, ZB, XB, ZB)
            else:
                # (A, B) <- (2A, A+B)
                self.xadd(XB, ZB, XA, ZA, XB, ZB, RX0, None)
                self.xdbl(XA, ZA, XA, ZA)


def _stage1(eng: Engine, m: MontOps, x0: int, b1: int) -> None:
    eng.set_int(RX0, x0)
    k = pr.build_e(b1)
    m.ladder(k)


def _stage1_backtrack(eng: Engine, m: MontOps, n: int, b1: int,
                      log) -> int:
    """When gcd(Z, N) == N (every factor's order divides k), replay the
    prime powers one at a time and gcd after each, returning the first
    proper factor (reference handles this by curve retry; a backtrack
    salvages the curve)."""
    eng.copy(XA, RX0)
    eng.set(ZA, 1)
    for pw in pr.prime_powers_upto(b1):
        _ladder_from(eng, m, GDX, GDZ, XA, ZA, pw)
        eng.copy(XA, GDX)
        eng.copy(ZA, GDZ)
        g = gmp.gcd(eng.get_int(ZA) % n, n)
        if 1 < g < n:
            return g
        if g == n:
            return 0  # a single prime power jumped past all factors
    return 0


def _stage2_D(opts: Options) -> int:
    """Giant-step D, capped so every prime q > B1 maps to m >= 2
    (q >= 1.5 D guarantees round(q/D) >= 2)."""
    D = opts.stage2_d or 30
    while D > 2 and 3 * D > 2 * opts.b1:
        D //= 2
    return max(D, 2)


def _stage2(eng: Engine, m: MontOps, opts: Options, n: int, log) -> int:
    """Classic-path wrapper: run stage 2 and fetch the accumulator."""
    _stage2_run(eng, m, opts, n, log)
    return eng.get_int(RACC)


def _stage2_run(eng, m: MontOps, opts: Options, n: int, log) -> None:
    """Accumulates the stage-2 cross-product into RACC (all lanes when
    eng is batched — the schedule is curve-independent).

    Babies [j]S for j <= D/2, gcd(j, D) = 1; prime q is covered with
    m = round(q/D), j = |q - mD| since x([mD]S) == x([±j]S) when [q]S
    vanishes mod a factor (x(-P) = x(P) on Montgomery curves).
    """
    b1, b2 = opts.b1, opts.b2
    D = _stage2_D(opts)
    baby_js = [j for j in range(1, D // 2 + 1) if math.gcd(j, D) == 1]
    BX0 = ECM_BASE_REGS
    slots = {}
    for idx, j in enumerate(baby_js):
        sx, sz = BX0 + 2 * idx, BX0 + 2 * idx + 1
        _ladder_from(eng, m, sx, sz, XA, ZA, j)
        slots[j] = (sx, sz)

    m0 = max((b1 + D // 2) // D, 1)
    _ladder_from(eng, m, GDX, GDZ, XA, ZA, D)
    _ladder_from(eng, m, RGX, RGZ, XA, ZA, m0 * D)
    if m0 > 1:
        _ladder_from(eng, m, PRVX, PRVZ, XA, ZA, (m0 - 1) * D)
    else:
        eng.copy(PRVX, XA)  # unused placeholder when m0 == 1
        eng.copy(PRVZ, ZA)

    eng.set(RACC, 1)
    mcur = m0
    count = 0
    for block in pr.segmented_primes(b1 + 1, b2 + 1):
        for q in block.tolist():
            if math.gcd(q, D) != 1:
                continue
            mq = (q + D // 2) // D  # round(q / D)
            while mcur < mq:
                m.xadd(T3, T4, RGX, RGZ, GDX, GDZ, PRVX, PRVZ)
                eng.copy(PRVX, RGX)
                eng.copy(PRVZ, RGZ)
                eng.copy(RGX, T3)
                eng.copy(RGZ, T4)
                mcur += 1
            j = abs(q - mcur * D)
            if j == 0:
                continue
            sx, sz = slots[j]
            # cross = X_G * Z_j - X_j * Z_G
            m.mul_into(T3, RGX, sz)
            m.mul_into(T4, RGZ, sx)
            eng.sub_reg(T3, T4)
            m.mul_into(RACC, RACC, T3)
            count += 1
    log(f"ECM stage 2: {count} primes in ({b1}, {b2}]")


def _ladder_from(eng: Engine, m: MontOps, xo: int, zo: int,
                 px: int, pz: int, k: int):
    """(xo:zo) = [k](px:pz) for arbitrary projective base (generic ladder).

    Uses (RPX, RPZ) and (T...)-adjacent scratch; clobbers XB/ZB.
    """
    assert k >= 1
    U = (RPX, RPZ)
    eng.copy(U[0], px)
    eng.copy(U[1], pz)
    if k == 1:
        eng.copy(xo, px)
        eng.copy(zo, pz)
        return
    # A = P, B = 2P, difference is P itself (projective)
    AX2, AZ2 = xo, zo
    eng.copy(AX2, px)
    eng.copy(AZ2, pz)
    m.xdbl(XB, ZB, AX2, AZ2)
    for i in range(k.bit_length() - 2, -1, -1):
        if (k >> i) & 1:
            m.xadd(AX2, AZ2, AX2, AZ2, XB, ZB, U[0], U[1])
            m.xdbl(XB, ZB, XB, ZB)
        else:
            m.xadd(XB, ZB, AX2, AZ2, XB, ZB, U[0], U[1])
            m.xdbl(AX2, AZ2, AX2, AZ2)


def _make_curve(family: str, seed0: int, c: int, opts: Options,
                n: int) -> tuple[int, int, int]:
    """(sigma_or_param, x0, a24) for curve index c; raises _FactorFound
    on a lucky non-invertible construction denominator."""
    sigma = 6 + splitmix64(seed0 + c) % ((1 << 60) - 6)
    if opts.sigma and c == 0:
        sigma = int(opts.sigma)
    if family == "torsion16":
        x0, a24, sigma = torsion16_mont_curve(seed0 + c, n)
    elif family == "torsion8":
        x0, a24, sigma = torsion8_curve(seed0 + c, n)
    else:
        x0, a24 = suyama_curve(sigma, n)
    return sigma, x0, a24


def _backtrack_single(opts: Options, x0: int, a24: int, n: int,
                      log, device=None) -> int:
    """Stage-1 backtrack for one batched lane whose gcd hit N: replay the
    curve on a fresh single-lane engine (rare path)."""
    eng = create_engine(opts.exponent, ECM_BASE_REGS, device=device,
                        backend=opts.backend, arith=opts.arith,
                        workload="ecm")
    m = MontOps(eng)
    eng.set_int(RA24, a24)
    eng.set_int(RX0, x0)
    return _stage1_backtrack(eng, m, n, opts.b1, log)


def _run_ecm_batch(opts: Options, log, n: int, K: int, family: str,
                   seed0: int, result: EcmResult, record) -> bool:
    """SPMD curve batching (the JAX package's BatchJaxEngine, K curves as
    lanes of one batched register file) is not yet ported: where the
    reference would batch, say so and return False, which the caller
    takes as "run the classic per-curve loop" (the reference's
    PRMERS_ECM_NO_BATCH path)."""
    if os.environ.get("PRMERS_ECM_NO_BATCH"):
        return False
    if opts.backend not in ("auto", "jax"):
        return False
    if getattr(opts, "arith", "auto") not in ("auto", "gl64"):
        return False
    log("ECM: batched curves are not yet ported to prmers_tpu_torch; "
        "running the classic per-curve loop")
    return False

def run_ecm(opts: Options, log=print, device=None) -> EcmResult:
    """K curves of Montgomery ECM on M_p with deterministic sigma seeds."""
    p = opts.exponent
    n = (1 << p) - 1
    t0 = time.monotonic()
    K = max(opts.curves, 1)
    D = _stage2_D(opts)
    n_babies = len([j for j in range(1, D // 2 + 1) if math.gcd(j, D) == 1])
    regs = ECM_BASE_REGS + 2 * n_babies + 2
    seed0 = opts.curve_seed or 0x5EED
    result = EcmResult(p=p, b1=opts.b1, b2=opts.b2, curves=K)
    keep_going = getattr(opts, "continue_after_factor", False)

    def record(f: int, stage: int, sig: int, curve: int) -> bool:
        """Record a factor; True = stop the curve loop (default), False
        when -ecm-continue-after-factor keeps the remaining curves."""
        result.factors = result.factors + (f,)
        if not result.factor:
            result.factor, result.stage = f, stage
            result.factor_sigma, result.factor_curve = sig, curve
        if not keep_going:
            log("[ECM] New factor found; stopping ECM by default. "
                "(-ecm-continue-after-factor keeps the remaining curves)")
        return not keep_going

    torsion = getattr(opts, "torsion", 0)
    family = ("torsion16" if torsion == 16 else
              "torsion8" if torsion == 8 else "suyama")
    if opts.sigma:
        family = "suyama"          # forced sigma implies the Suyama map
    if K > 1 and _run_ecm_batch(opts, log, n, K, family, seed0,
                                result, record):
        result.elapsed = time.monotonic() - t0
        if not result.factor:
            log("[ECM] No factor found")
        return result
    eng = create_engine(p, regs, device=device, backend=opts.backend,
                        arith=opts.arith, workload="ecm")
    m = MontOps(eng)
    for c in range(K):
        sigma = 6 + splitmix64(seed0 + c) % ((1 << 60) - 6)
        if opts.sigma and c == 0:
            sigma = int(opts.sigma)
        try:
            if family == "torsion16":
                x0, a24, sigma = torsion16_mont_curve(seed0 + c, n)
            elif family == "torsion8":
                x0, a24, sigma = torsion8_curve(seed0 + c, n)
            else:
                x0, a24 = suyama_curve(sigma, n)
        except _FactorFound as f:
            if f.f and record(f.f, 0, sigma, c):
                break
            continue
        eng.set_int(RA24, a24)
        _stage1(eng, m, x0, opts.b1)
        if opts.resume_save:
            try:
                from ..io import interop
                za = eng.get_int(ZA) % n
                x_aff = gmp.mulmod(eng.get_int(XA) % n,
                                   _inv_or_factor(za, n), n)
                a_mont = (4 * a24 - 2) % n
                if family == "suyama":
                    interop.write_ecm_resume_ecm(opts.resume_save,
                                                 opts.b1, p, x_aff,
                                                 sigma=sigma)
                else:
                    interop.write_ecm_resume_ecm(opts.resume_save,
                                                 opts.b1, p, x_aff,
                                                 a=a_mont)
                log(f"ECM stage-1 resume line appended to "
                    f"{opts.resume_save}")
            except _FactorFound:
                pass  # the gcd below reports it
        g = gmp.gcd(eng.get_int(ZA) % n, n)
        if g == n:
            log(f"ECM curve {c}: gcd == N, backtracking stage 1")
            g = _stage1_backtrack(eng, m, n, opts.b1, log)
        if 1 < g < n:
            log(f"ECM curve {c} (sigma={sigma}) stage 1 factor {g}")
            if record(g, 1, sigma, c):
                break
            continue
        if g == 1 and opts.b2 > opts.b1:
            handed_off = False
            if getattr(opts, "p95_path", "") and \
                    getattr(opts, "p95_stage2", True):
                # external Prime95 stage 2 for this curve (reference:
                # p95_enqueue_curve, RunEcmTwistedEdwards.cpp:1160-1199);
                # orchestration failure falls back to the internal one
                from ..io import interop, p95
                za = eng.get_int(ZA) % n
                try:
                    x_aff = gmp.mulmod(eng.get_int(XA) % n,
                                       _inv_or_factor(za, n), n)
                except _FactorFound as f:
                    if f.f and record(f.f, 1, sigma, c):
                        break
                    continue
                import tempfile
                with tempfile.TemporaryDirectory() as td:
                    src = os.path.join(td, f"resume_p{p}_c{c}.save")
                    a_mont = (4 * a24 - 2) % n
                    if family == "suyama":
                        interop.write_ecm_resume_ecm(src, opts.b1, p,
                                                     x_aff, sigma=sigma)
                    else:
                        interop.write_ecm_resume_ecm(src, opts.b1, p,
                                                     x_aff, a=a_mont)
                    rr = p95.run_ecm_stage2(
                        opts.p95_path, p, opts.b2, src, curve_idx=c,
                        known_factors=tuple(
                            int(f) for f in opts.known_factors),
                        log=log)
                if rr.success:
                    handed_off = True
                    g = 0 if rr.known_factor else rr.factor
                    if 1 < g < n:
                        log(f"ECM curve {c} (sigma={sigma}) stage 2 "
                            f"factor {g} (Prime95)")
                        if record(g, 2, sigma, c):
                            break
                        continue
                else:
                    log(f"[ECM] Prime95 Stage2 error: {rr.error}; "
                        "falling back to the internal stage 2")
            if not handed_off:
                acc = _stage2(eng, m, opts, n, log)
                g = gmp.gcd(acc % n, n)
                if 1 < g < n:
                    log(f"ECM curve {c} (sigma={sigma}) stage 2 factor "
                        f"{g}")
                    if record(g, 2, sigma, c):
                        break
                    continue
        log(f"ECM curve {c} (sigma={sigma}): no factor")
    result.elapsed = time.monotonic() - t0
    if not result.factor:
        log("[ECM] No factor found")
    return result
