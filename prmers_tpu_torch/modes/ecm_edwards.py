"""ECM on twisted Edwards curves (a = -1, extended coordinates) — the
default ECM path, mirroring the reference's register-level Edwards driver
(reference: src/modes/RunEcmTwistedEdwards.cpp:834 — 51-register extended
twisted-Edwards program, unified add :2694-2772, doubling :2869+, periodic
invariant check via -ecm_check_interval, prepared multiplicands cached in
registers :1859-1863).

Curve construction: deterministic (x0, y0) from the per-curve seed and
d = (y0^2 - x0^2 - 1) / (x0^2 y0^2) mod N — every (x0, y0) lies on exactly
one a=-1 curve, and the construction needs no square root mod the
composite N. (The reference's torsion-8/16 parametrizations buy a better
smoothness constant; the generic construction is functionally complete —
torsion families are a planned refinement.)

Formulas (extended coordinates (X:Y:Z:T), T = XY/Z, a = -1; the ed25519
sign-correct forms of HWCD 2008):

  dbl:  A=X^2 B=Y^2 C=2Z^2 H=A+B E=H-(X+Y)^2 G=A-B F=C+G
        X3=E*F Y3=G*H T3=E*H Z3=F*G
  add (second operand cached as the prepared quad
       (Y2-X2, Y2+X2, 2d*T2, 2*Z2), all in multiplicand form):
        A=(Y1-X1)*q0 B=(Y1+X1)*q1 C=T1*q2 D=Z1*q3
        E=B-A H=B+A F=D-C G=D+C -> X3=E*F Y3=G*H T3=E*H Z3=F*G

Stage 1: [k]P by left-to-right double-and-add, k = prod p^floor(log_p B1);
a factor q divides gcd(X, N) iff the curve order mod q divides k
(identity = (0, 1)). Stage 2: BSGS over primes in (B1, B2] using
y-coordinate cross-products (y(-P) = y(P) on Edwards, so the +-j wheel
works exactly like Montgomery x-coordinates).

Port: a copy of prmers_tpu/modes/ecm_edwards.py. Its changes, as in
ecm.py: `device=` runs from run_ecm_edwards (and _backtrack_single_ed)
into create_engine; _run_edwards_batch logs that batched curves are not
yet ported and returns False, so the classic per-curve loop runs.
"""

from __future__ import annotations

import math
import time

from ..engine.api import Engine
from ..engine.factory import create_engine
from ..io.options import Options
from ..utils import gmp
from ..utils import primes as pr
from .ecm import EcmResult, _FactorFound, _inv_or_factor, splitmix64

# register map --------------------------------------------------------------
EX, EY, EZ, ET = 0, 1, 2, 3                  # current point
BQ0, BQ1, BQ2, BQ3 = 4, 5, 6, 7              # prepared base quad
R2D = 8                                      # multiplicand: 2d
RDM = 9                                      # multiplicand: d  (invariant)
TA, TB, TC, TD, TE, TG, TH = 10, 11, 12, 13, 14, 15, 16
M_E, M_G = 17, 18                            # multiplicand scratch
RACC = 19
GX, GY, GZ, GT = 20, 21, 22, 23              # giant point (stage 2)
PD0, PD1, PD2, PD3 = 24, 25, 26, 27          # prepared step quad
SX, SY, SZ, ST = 28, 29, 30, 31              # saved point scratch
BQ4, PD4 = 32, 33                            # 5th quad slots (a = +1 adds)
ED_BASE_REGS = 34


def _aux_mul(m: int, x0: int, y0: int, n: int):
    """m * (x0, y0) on the auxiliary curve y^2 = x^3 + 4x over Z/n
    (host arithmetic; a non-invertible denominator raises _FactorFound —
    finding a factor during construction counts)."""
    def inv(v):
        return _inv_or_factor(v % n, n)

    def dbl(P):
        if P is None:
            return None
        x, y = P
        if y % n == 0:
            return None
        lam = (3 * x * x + 4) * inv(2 * y) % n
        x3 = (lam * lam - 2 * x) % n
        return (x3, (lam * (x - x3) - y) % n)

    def add(P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        if (P[0] - Q[0]) % n == 0:
            if (P[1] + Q[1]) % n == 0:
                return None
            return dbl(P)
        lam = (Q[1] - P[1]) * inv(Q[0] - P[0]) % n
        x3 = (lam * lam - P[0] - Q[0]) % n
        return (x3, (lam * (P[0] - x3) - P[1]) % n)

    P0 = (x0 % n, y0 % n)
    P = P0
    for b in range(m.bit_length() - 2, -1, -1):
        P = dbl(P)
        if (m >> b) & 1:
            P = add(P, P0)
        if P is None:
            return None
    return P


def torsion16_curve(seed: int, n: int) -> tuple[int, int, int]:
    """a = +1 twisted Edwards curve with rational 16-torsion
    (reference: the torsion-16 construction of
    RunEcmTwistedEdwards.cpp:2228-2354 — point m*(4, 8) on y^2 = x^3+4x,
    then alpha/r/t1 algebra yields (X0, Y0, d) with X0^2+Y0^2 = 1+d X0^2 Y0^2).
    Raises _FactorFound when a construction inverse reveals a factor."""
    for tries in range(128):
        m = splitmix64(seed ^ 0x544F523136 ^ tries) | 1
        if m < 3:
            m += 2
        try:
            st = _aux_mul(m, 4, 8, n)
            if st is None:
                continue
            s, t = st
            alpha = (t + 8) * _inv_or_factor(s - 4, n) % n
            a2 = alpha * alpha % n
            r = (8 + 2 * alpha) * _inv_or_factor(8 - a2, n) % n
            t1 = pow(2 * r - 1, 2, n)
            d = (8 * r * r - 8 * r + 1) * _inv_or_factor(t1 * t1 % n, n) % n
            if d in (0, 1, n - 1):
                continue
            x0 = ((8 - a2) * (2 * r * r - 1)
                  ) * _inv_or_factor(2 * s - a2 + 4, n) % n
            y0 = t1 * _inv_or_factor(4 * r - 3, n) % n
            if x0 == 0 or y0 == 0:
                continue
            lhs = (x0 * x0 + y0 * y0) % n
            rhs = (1 + d * x0 % n * x0 % n * y0 % n * y0) % n
            if lhs != rhs:
                continue
            return x0, y0, d
        except _FactorFound as f:
            if f.f:
                raise
            continue
    raise _FactorFound(0)   # no usable curve from this seed


def family_iv163_curve(seed: int, n: int) -> tuple[int, int, int]:
    """a = -1 twisted Edwards curve from the rational IV-163 family
    (reference: the family_iv_163 construction,
    src/modes/RunEcmTwistedEdwards.cpp:2360-2430): m*(5, 8) on the
    auxiliary curve y^2 = x^3 - x^2 - 9x + 9 over EXACT rationals, then
      t = (4x+4)/(y-4),  e = (t^2+4t)/(t^2-4),  d = -e^4,
      X = (2t^3 + 2t^2 - 8t - 8) / (t^4 + 6t^3 + 12t^2 + 16t),
      Y = (t^6+6t^5+10t^4-16t^3-48t^2-32t-32) /
          (t^6+6t^5+10t^4+16t^3+48t^2+64t),
    reduced mod n (denominator inverses may reveal a factor)."""
    from fractions import Fraction as Fr

    def q_add(P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        if P[0] == Q[0]:
            if P[1] == -Q[1] or P[1] == 0:
                return None
            lam = (3 * P[0] * P[0] - 2 * P[0] - 9) / (2 * P[1])
        else:
            lam = (Q[1] - P[1]) / (Q[0] - P[0])
        x3 = lam * lam + 1 - P[0] - Q[0]
        return (x3, -P[1] - lam * (x3 - P[0]))

    def to_mod(q: Fr) -> int:
        return q.numerator % n * _inv_or_factor(q.denominator, n) % n

    for tries in range(128):
        m = 1 + splitmix64(seed ^ (0x163163 + tries)) % 100
        P = None
        Q = (Fr(5), Fr(8))
        k = m
        while k:
            if k & 1:
                P = q_add(P, Q)
            k >>= 1
            if k:
                Q = q_add(Q, Q)
                if Q is None:
                    break
        if P is None or Q is None and k:
            continue
        x, y = P
        if y == 4:
            continue
        t = (4 * x + 4) / (y - 4)
        t2 = t * t
        if t2 == 4:
            continue
        e = (t2 + 4 * t) / (t2 - 4)
        if e == 0:
            continue
        t3 = t2 * t
        t4 = t2 * t2
        t6 = t4 * t2
        denx = t4 + 6 * t3 + 12 * t2 + 16 * t
        deny = t6 + 6 * t4 * t + 10 * t4 + 16 * t3 + 48 * t2 + 64 * t
        if denx == 0 or deny == 0:
            continue
        Xq = (2 * t3 + 2 * t2 - 8 * t - 8) / denx
        Yq = (t6 + 6 * t4 * t + 10 * t4 - 16 * t3 - 48 * t2
              - 32 * t - 32) / deny
        dq = -(e ** 4)
        try:
            d = to_mod(dq)
            x0 = to_mod(Xq)
            y0 = to_mod(Yq)
        except _FactorFound as f:
            if f.f:
                raise
            continue
        if d in (0, 1, n - 1) or x0 == 0 or y0 == 0:
            continue
        lhs = (-x0 * x0 + y0 * y0) % n
        rhs = (1 + d * x0 % n * x0 % n * y0 % n * y0) % n
        if lhs != rhs:
            continue
        return x0, y0, d
    raise _FactorFound(0)


def edwards_curve(seed: int, n: int) -> tuple[int, int, int]:
    """(x0, y0, d) with -x0^2 + y0^2 = 1 + d x0^2 y0^2 (mod n)."""
    x0 = 2 + splitmix64(seed) % (1 << 48)
    y0 = 3 + splitmix64(seed ^ 0xE0E0) % (1 << 48)
    num = (y0 * y0 - x0 * x0 - 1) % n
    den = (x0 * x0 % n) * (y0 * y0 % n) % n
    d = gmp.mulmod(num, _inv_or_factor(den, n), n)
    if d == 0 or (d + 1) % n == 0:   # singular / a == d degeneracies
        raise _FactorFound(0)
    return x0, y0, d


class EdOps:
    """Extended twisted-Edwards point ops over engine registers.

    a_sign selects the curve family: -1 uses the ed25519 forms (generic
    d-from-point curves); +1 the general-a HWCD forms (torsion-16 family,
    whose prepared quads carry a fifth element X2+Y2)."""

    def __init__(self, eng: Engine, n: int, d: int, a_sign: int = -1):
        self.e = eng
        self.n = n
        self.d = d
        self.a_sign = a_sign
        eng.set_int(TA, (2 * d) % n)
        eng.set_multiplicand(R2D, TA)
        eng.set_int(TA, d)
        eng.set_multiplicand(RDM, TA)

    # -- point load/store -------------------------------------------------
    def set_affine(self, x0: int, y0: int):
        e = self.e
        n = self.n
        e.set_int(EX, x0 % n)
        e.set_int(EY, y0 % n)
        e.set(EZ, 1)
        e.set_int(ET, x0 * y0 % n)

    def _q5(self, q0: int) -> int:
        """Register of a quad's fifth element (a = +1 layout)."""
        return BQ4 if q0 == BQ0 else PD4

    def prep_quad_host(self, q0: int, x0: int, y0: int):
        """Prepared quad of an affine host point into regs q0..q0+3."""
        e = self.e
        n = self.n
        if self.a_sign == -1:
            e.set_int(TA, (y0 - x0) % n)
            e.set_multiplicand(q0, TA)
            e.set_int(TA, (y0 + x0) % n)
            e.set_multiplicand(q0 + 1, TA)
            e.set_int(TA, 2 * self.d % n * (x0 * y0 % n) % n)
            e.set_multiplicand(q0 + 2, TA)
            e.set(TA, 2)
            e.set_multiplicand(q0 + 3, TA)
            return
        e.set_int(TA, x0 % n)
        e.set_multiplicand(q0, TA)
        e.set_int(TA, y0 % n)
        e.set_multiplicand(q0 + 1, TA)
        e.set_int(TA, self.d * (x0 * y0 % n) % n)
        e.set_multiplicand(q0 + 2, TA)
        e.set(TA, 1)
        e.set_multiplicand(q0 + 3, TA)
        e.set_int(TA, (x0 + y0) % n)
        e.set_multiplicand(self._q5(q0), TA)

    def prep_quad_reg(self, q0: int, px: int, py: int, pz: int, pt: int):
        """Prepared quad of a register point (clobbers TA/TB)."""
        e = self.e
        if self.a_sign == -1:
            e.copy(TA, py)
            e.sub_reg(TA, px)
            e.set_multiplicand(q0, TA)
            e.copy(TA, py)
            e.add(TA, px)
            e.set_multiplicand(q0 + 1, TA)
            e.copy(TA, pt)
            e.mul(TA, R2D)
            e.set_multiplicand(q0 + 2, TA)
            e.copy(TA, pz)
            e.copy(TB, pz)
            e.add(TA, TB)
            e.set_multiplicand(q0 + 3, TA)
            return
        e.copy(TA, px)
        e.set_multiplicand(q0, TA)
        e.copy(TA, py)
        e.set_multiplicand(q0 + 1, TA)
        e.copy(TA, pt)
        e.mul(TA, RDM)                    # d * T2 (a=+1 uses d, not 2d)
        e.set_multiplicand(q0 + 2, TA)
        e.copy(TA, pz)
        e.set_multiplicand(q0 + 3, TA)
        e.copy(TA, px)
        e.add(TA, py)
        e.set_multiplicand(self._q5(q0), TA)

    # -- group ops ---------------------------------------------------------
    def dbl(self):
        """(EX:EY:EZ:ET) = 2 * (EX:EY:EZ:ET)."""
        e = self.e
        e.copy(TA, EX)
        e.square_mul(TA)                 # A = X^2
        e.copy(TB, EY)
        e.square_mul(TB)                 # B = Y^2
        e.copy(TC, EZ)
        e.square_mul(TC)
        e.copy(TD, TC)
        e.add(TC, TD)                    # C = 2 Z^2
        e.copy(TE, EX)
        e.add(TE, EY)
        e.square_mul(TE)                 # (X+Y)^2
        if self.a_sign == -1:
            e.copy(TH, TA)
            e.add(TH, TB)                # H = A + B
            e.copy(TG, TA)
            e.sub_reg(TG, TB)            # G = A - B
            e.copy(TA, TH)
            e.sub_reg(TA, TE)            # E = H - (X+Y)^2
            e.copy(TB, TC)
            e.add(TB, TG)                # F = C + G
            e.set_multiplicand(M_E, TA)
            e.set_multiplicand(M_G, TG)
            e.copy(EX, TB)
            e.mul(EX, M_E)               # X3 = E*F
            e.copy(ET, TH)
            e.mul(ET, M_E)               # T3 = E*H
            e.copy(EY, TH)
            e.mul(EY, M_G)               # Y3 = G*H
            e.copy(EZ, TB)
            e.mul(EZ, M_G)               # Z3 = F*G
            return
        # a = +1 (dbl-2008-hwcd with a=1):
        # E=(X+Y)^2-A-B, G=A+B, F=G-C, H=A-B
        e.copy(TH, TA)
        e.add(TH, TB)                    # G = A + B
        e.copy(TG, TA)
        e.sub_reg(TG, TB)                # H = A - B
        e.copy(TD, TE)
        e.sub_reg(TD, TH)                # E = (X+Y)^2 - (A+B)
        e.copy(TE, TH)
        e.sub_reg(TE, TC)                # F = G - C
        e.set_multiplicand(M_E, TD)
        e.set_multiplicand(M_G, TH)      # multiplicand of G
        e.copy(EX, TE)
        e.mul(EX, M_E)                   # X3 = E*F
        e.copy(ET, TG)
        e.mul(ET, M_E)                   # T3 = E*H
        e.copy(EY, TG)
        e.mul(EY, M_G)                   # Y3 = G*H
        e.copy(EZ, TE)
        e.mul(EZ, M_G)                   # Z3 = F*G

    def add_quad(self, q0: int):
        """(EX:EY:EZ:ET) += point whose prepared quad is at q0..q0+3."""
        e = self.e
        if self.a_sign == -1:
            e.copy(TA, EY)
            e.sub_reg(TA, EX)
            e.mul(TA, q0)                # A = (Y1-X1)(Y2-X2)
            e.copy(TB, EY)
            e.add(TB, EX)
            e.mul(TB, q0 + 1)            # B = (Y1+X1)(Y2+X2)
            e.copy(TC, ET)
            e.mul(TC, q0 + 2)            # C = T1 * 2d T2
            e.copy(TD, EZ)
            e.mul(TD, q0 + 3)            # D = Z1 * 2 Z2
            e.addsub(TH, TE, TB, TA)     # H = B+A, E = B-A
            e.addsub(TG, TB, TD, TC)     # G = D+C, F (TB) = D-C
            e.set_multiplicand(M_E, TE)
            e.set_multiplicand(M_G, TG)
            e.copy(EX, TB)
            e.mul(EX, M_E)               # X3 = E*F
            e.copy(ET, TH)
            e.mul(ET, M_E)               # T3 = E*H
            e.copy(EY, TH)
            e.mul(EY, M_G)               # Y3 = G*H
            e.copy(EZ, TB)
            e.mul(EZ, M_G)               # Z3 = F*G
            return
        # a = +1 (add-2008-hwcd, a=1): A=X1*X2, B=Y1*Y2, C=d*T1*T2,
        # D=Z1*Z2, E=(X1+Y1)(X2+Y2)-A-B, F=D-C, G=D+C, H=B-A
        e.copy(TA, EX)
        e.mul(TA, q0)                    # A
        e.copy(TB, EY)
        e.mul(TB, q0 + 1)                # B
        e.copy(TC, ET)
        e.mul(TC, q0 + 2)                # C = T1 * d T2
        e.copy(TD, EZ)
        e.mul(TD, q0 + 3)                # D
        e.copy(TE, EX)
        e.add(TE, EY)
        e.mul(TE, self._q5(q0))          # (X1+Y1)(X2+Y2)
        e.sub_reg(TE, TA)
        e.sub_reg(TE, TB)                # E
        e.addsub(TG, TD, TD, TC)         # G = D+C, F (TD) = D-C
        e.copy(TH, TB)
        e.sub_reg(TH, TA)                # H = B - A
        e.set_multiplicand(M_E, TE)
        e.set_multiplicand(M_G, TG)
        e.copy(EX, TD)
        e.mul(EX, M_E)                   # X3 = E*F
        e.copy(ET, TH)
        e.mul(ET, M_E)                   # T3 = E*H
        e.copy(EY, TH)
        e.mul(EY, M_G)                   # Y3 = G*H
        e.copy(EZ, TD)
        e.mul(EZ, M_G)                   # Z3 = F*G

    def scalar_mul_quad(self, k: int, q0: int):
        """Current point = [k] * (point of quad q0), where the current
        point ALREADY holds that point (left-to-right binary)."""
        for i in range(k.bit_length() - 2, -1, -1):
            self.dbl()
            if (k >> i) & 1:
                self.add_quad(q0)

    # -- checks -------------------------------------------------------------
    def invariant_ok(self) -> bool:
        """a X^2 + Y^2 == Z^2 + d T^2 (projective curve equation)."""
        e = self.e
        e.copy(TA, EY)
        e.square_mul(TA)
        e.copy(TB, EX)
        e.square_mul(TB)
        if self.a_sign == -1:
            e.sub_reg(TA, TB)
        else:
            e.add(TA, TB)
        e.copy(TB, EZ)
        e.square_mul(TB)
        e.copy(TC, ET)
        e.square_mul(TC)
        e.mul(TC, RDM)
        e.add(TB, TC)
        return e.is_equal(TA, TB)

    def save(self):
        e = self.e
        for d_, s in ((SX, EX), (SY, EY), (SZ, EZ), (ST, ET)):
            e.copy(d_, s)

    def restore(self):
        e = self.e
        for d_, s in ((EX, SX), (EY, SY), (EZ, SZ), (ET, ST)):
            e.copy(d_, s)


def _stage1(ops: EdOps, x0: int, y0: int, b1: int, check_every: int,
            log) -> None:
    ops.set_affine(x0, y0)
    ops.prep_quad_host(BQ0, x0, y0)
    k = pr.build_e(b1)
    since = 0
    ops.save()
    for i in range(k.bit_length() - 2, -1, -1):
        ops.dbl()
        if (k >> i) & 1:
            ops.add_quad(BQ0)
        since += 1
        if check_every and since >= check_every:
            if not ops.invariant_ok():
                log("ECM: invariant check FAILED — replaying window")
                ops.restore()
                raise _GlRetry(i)
            ops.save()
            since = 0
    if check_every and not ops.invariant_ok():
        log("ECM: final invariant check FAILED")
        raise _GlRetry(-1)


class _GlRetry(RuntimeError):
    def __init__(self, bit: int):
        self.bit = bit


def _stage1_backtrack(ops: EdOps, n: int, x0: int, y0: int, b1: int) -> int:
    """gcd(X, N) == N: every factor's order divides k. Replay the prime
    powers one at a time from the base point, gcd after each — the first
    prime power past a single factor's order isolates it (reference: the
    Montgomery driver's equivalent salvage, RunEcm.cpp g==N path)."""
    e = ops.e
    ops.set_affine(x0, y0)
    for pw in pr.prime_powers_upto(b1):
        ops.prep_quad_reg(PD0, EX, EY, EZ, ET)
        ops.scalar_mul_quad(pw, PD0)
        g = gmp.gcd(e.get_int(EX) % n, n)
        if 1 < g < n:
            return g
        if g == n:
            return 0  # one prime power jumped past all factors at once
    return 0


def _stage2(ops: EdOps, opts: Options, n: int, log) -> int:
    """Classic-path wrapper: run stage 2 and fetch the accumulator."""
    _stage2_run(ops, opts, n, log)
    return ops.e.get_int(RACC)


def _stage2_run(ops: EdOps, opts: Options, n: int, log) -> None:
    """BSGS with y-coordinate cross-products; accumulates into RACC (all
    lanes when ops.e is batched — the schedule is curve-independent)."""
    e = ops.e
    b1, b2 = opts.b1, opts.b2
    from .ecm import _stage2_D
    D = _stage2_D(opts)
    baby_js = [j for j in range(1, D // 2 + 1) if math.gcd(j, D) == 1]
    slots = {}
    BY0 = ED_BASE_REGS

    # Q = stage-1 point; walk [j]Q for odd j via repeated += [2]Q
    ops.prep_quad_reg(PD0, EX, EY, EZ, ET)    # quad(Q)
    ops.save()                                # save Q
    ops.dbl()                                 # current = [2]Q
    ops.prep_quad_reg(BQ0, EX, EY, EZ, ET)    # quad([2]Q) reuses base slot
    ops.restore()                             # current = [1]Q
    j = 1
    idx = 0
    for jj in baby_js:
        while j < jj:
            # [2]Q steps when possible; a single [1]Q step covers the odd
            # parity change that even baby residues of an odd D require
            if jj - j >= 2:
                ops.add_quad(BQ0)
                j += 2
            else:
                ops.add_quad(PD0)
                j += 1
        sy, sz = BY0 + 2 * idx, BY0 + 2 * idx + 1
        e.copy(sy, EY)
        e.copy(sz, EZ)
        slots[jj] = (sy, sz)
        idx += 1

    # giants: G = [m0 D]Q, step [D]Q
    ops.restore()
    ops.scalar_mul_quad(D, PD0)               # current = [D]Q
    ops.prep_quad_reg(PD0, EX, EY, EZ, ET)    # quad([D]Q)
    m0 = max((b1 + D // 2) // D, 1)
    if m0 > 1:
        ops.scalar_mul_quad(m0, PD0)          # [m0 D]Q from [D]Q
    e.copy(GX, EX)
    e.copy(GY, EY)
    e.copy(GZ, EZ)
    e.copy(GT, ET)

    e.set(RACC, 1)
    mcur = m0
    count = 0
    for block in pr.segmented_primes(b1 + 1, b2 + 1):
        for q in block.tolist():
            if math.gcd(q, D) != 1:
                continue
            mq = (q + D // 2) // D
            while mcur < mq:
                e.copy(EX, GX)
                e.copy(EY, GY)
                e.copy(EZ, GZ)
                e.copy(ET, GT)
                ops.add_quad(PD0)
                e.copy(GX, EX)
                e.copy(GY, EY)
                e.copy(GZ, EZ)
                e.copy(GT, ET)
                mcur += 1
            jj = abs(q - mcur * D)
            if jj == 0:
                continue
            sy, sz = slots[jj]
            # cross = Y_G * Z_j - Y_j * Z_G   (y(-P) = y(P))
            e.copy(TA, sz)
            e.set_multiplicand(M_E, TA)
            e.copy(TB, GY)
            e.mul(TB, M_E)
            e.copy(TA, sy)
            e.set_multiplicand(M_E, TA)
            e.copy(TC, GZ)
            e.mul(TC, M_E)
            e.sub_reg(TB, TC)
            e.set_multiplicand(M_E, TB)
            e.mul(RACC, M_E)
            count += 1
    log(f"ECM-Edwards stage 2: {count} primes in ({b1}, {b2}]")


class BatchEdOps(EdOps):
    """EdOps over a curve-batched register file: the group ops are
    inherited verbatim (their schedule is curve-independent); only the
    host-constant loads differ — per-lane values fill the scratch
    register lane by lane before one batched set_multiplicand."""

    def __init__(self, eng, n: int, ds: list[int], a_sign: int = -1):
        self.e = eng
        self.n = n
        self.d = ds[0]
        self.ds = ds
        self.a_sign = a_sign
        for li, d in enumerate(ds):
            eng.set_int(TA, (2 * d) % n, li)
        eng.set_multiplicand(R2D, TA)
        for li, d in enumerate(ds):
            eng.set_int(TA, d % n, li)
        eng.set_multiplicand(RDM, TA)

    def set_affine_lanes(self, pts: list[tuple[int, int]]):
        e = self.e
        n = self.n
        for li, (x0, y0) in enumerate(pts):
            e.set_int(EX, x0 % n, li)
            e.set_int(EY, y0 % n, li)
            e.set_int(ET, x0 * y0 % n, li)
        e.set(EZ, 1)

    def prep_quad_host_lanes(self, q0: int, pts: list[tuple[int, int]]):
        e = self.e
        n = self.n

        def fill(vals_fn):
            for li, (x0, y0) in enumerate(pts):
                e.set_int(TA, vals_fn(x0, y0, self.ds[li]) % n, li)

        if self.a_sign == -1:
            fill(lambda x, y, d: y - x)
            e.set_multiplicand(q0, TA)
            fill(lambda x, y, d: y + x)
            e.set_multiplicand(q0 + 1, TA)
            fill(lambda x, y, d: 2 * d % n * (x * y % n))
            e.set_multiplicand(q0 + 2, TA)
            e.set(TA, 2)
            e.set_multiplicand(q0 + 3, TA)
            return
        fill(lambda x, y, d: x)
        e.set_multiplicand(q0, TA)
        fill(lambda x, y, d: y)
        e.set_multiplicand(q0 + 1, TA)
        fill(lambda x, y, d: d * (x * y % n))
        e.set_multiplicand(q0 + 2, TA)
        e.set(TA, 1)
        e.set_multiplicand(q0 + 3, TA)
        fill(lambda x, y, d: x + y)
        e.set_multiplicand(self._q5(q0), TA)

    def invariant_ok_lanes(self, live) -> bool:
        """Batched curve-equation check: compute both sides for every
        lane at once, compare only the live lanes on host."""
        e = self.e
        e.copy(TA, EY)
        e.square_mul(TA)
        e.copy(TB, EX)
        e.square_mul(TB)
        if self.a_sign == -1:
            e.sub_reg(TA, TB)
        else:
            e.add(TA, TB)
        e.copy(TB, EZ)
        e.square_mul(TB)
        e.copy(TC, ET)
        e.square_mul(TC)
        e.mul(TC, RDM)
        e.add(TB, TC)
        return all(e.get_int(TA, li) == e.get_int(TB, li)
                   for li in range(len(live)) if live[li])


def _run_edwards_batch(opts: Options, log, n: int, K: int,
                       result: EcmResult, record) -> bool:
    """SPMD curve batching for the twisted-Edwards driver (ecm.py's
    _run_ecm_batch): not yet ported. Where the reference would batch, say
    so and return False, so the classic per-curve loop runs."""
    import os
    if os.environ.get("PRMERS_ECM_NO_BATCH"):
        return False
    if opts.backend not in ("auto", "jax"):
        return False
    if getattr(opts, "arith", "auto") not in ("auto", "gl64"):
        return False
    if getattr(opts, "invariant_error_iter", 0):
        return False                # injection exercises the classic path
    log("ECM-Edwards: batched curves are not yet ported to "
        "prmers_tpu_torch; running the classic per-curve loop")
    return False

def _backtrack_single_ed(opts: Options, n: int, x0: int, y0: int,
                         d: int, a_sign: int, device=None) -> int:
    """Stage-1 backtrack for one batched lane on a fresh single-lane
    engine (rare path)."""
    eng = create_engine(opts.exponent, ED_BASE_REGS, device=device,
                        backend=opts.backend, arith=opts.arith,
                        workload="ecm")
    ops = EdOps(eng, n, d, a_sign=a_sign)
    return _stage1_backtrack(ops, n, x0, y0, opts.b1)


def run_ecm_edwards(opts: Options, log=print,
                    device=None) -> EcmResult:
    """K curves of twisted-Edwards ECM on M_p with deterministic seeds."""
    p = opts.exponent
    n = (1 << p) - 1
    t0 = time.monotonic()
    K = max(opts.curves, 1)
    from .ecm import _stage2_D
    D = _stage2_D(opts)
    n_babies = len([j for j in range(1, D // 2 + 1) if math.gcd(j, D) == 1])
    regs = ED_BASE_REGS + 2 * n_babies + 2
    seed0 = opts.curve_seed or 0x5EED
    check_every = getattr(opts, "ecm_check_interval", 0) or 0
    result = EcmResult(p=p, b1=opts.b1, b2=opts.b2, curves=K)
    keep_going = getattr(opts, "continue_after_factor", False)

    def record(f: int, stage: int, sig: int, curve: int) -> bool:
        """Record a factor; True = stop the curve loop (reference
        default), False when -ecm-continue-after-factor keeps going."""
        result.factors = result.factors + (f,)
        if not result.factor:
            result.factor, result.stage = f, stage
            result.factor_sigma, result.factor_curve = sig, curve
        if not keep_going:
            log("[ECM] New factor found; stopping ECM by default. "
                "(-ecm-continue-after-factor keeps the remaining curves)")
        return not keep_going

    if K > 1 and _run_edwards_batch(opts, log, n, K, result, record):
        result.elapsed = time.monotonic() - t0
        if not result.factor:
            log("[ECM] No factor found")
        return result
    eng = create_engine(p, regs, device=device, backend=opts.backend,
                        arith=opts.arith, workload="ecm")
    torsion = getattr(opts, "torsion", 0)
    use_t16 = torsion == 16
    use_iv163 = torsion == 163
    for c in range(K):
        seed = splitmix64(seed0 + c)
        try:
            if use_t16:
                x0, y0, d = torsion16_curve(seed, n)
            elif use_iv163:
                x0, y0, d = family_iv163_curve(seed, n)
            else:
                x0, y0, d = edwards_curve(seed, n)
        except _FactorFound as f:
            if f.f and record(f.f, 0, seed, c):
                break
            continue
        ops = EdOps(eng, n, d, a_sign=1 if use_t16 else -1)
        try:
            _stage1(ops, x0, y0, opts.b1, check_every, log)
        except _GlRetry:
            log(f"ECM-Edwards curve {c}: hardware invariant error, "
                "restarting curve")
            continue
        g = gmp.gcd(eng.get_int(EX) % n, n)
        hit_all = g == n
        if hit_all:
            log(f"ECM-Edwards curve {c}: gcd == N, backtracking stage 1")
            g = _stage1_backtrack(ops, n, x0, y0, opts.b1)
        if 1 < g < n:
            log(f"ECM-Edwards curve {c} stage 1 factor {g}")
            if record(g, 1, seed, c):
                break
            continue
        if hit_all:
            continue  # [k]P vanished mod every factor; stage 2 is moot
        if opts.b2 > opts.b1:
            acc = _stage2(ops, opts, n, log)
            g = gmp.gcd(acc % n, n)
            if 1 < g < n:
                log(f"ECM-Edwards curve {c} stage 2 factor {g}")
                if record(g, 2, seed, c):
                    break
                continue
        log(f"ECM-Edwards curve {c}: no factor")
    result.elapsed = time.monotonic() - t0
    if not result.factor:
        log("[ECM] No factor found")
    return result
