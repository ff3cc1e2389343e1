"""Four-step IBDWT plan and host-side tables (numpy) for the port's kernels.

Counterpart of prmers_tpu/ops/pallas/fourstep.py (plan, base tables, the
folded-table builders) and mxu_dft.py (the DFT matrices). The length-n
weighted transform is n = R*C with R = R1*R2; a register is (R1, R2, C)
and digit [r1, r2, c] is x[(r1*R2 + r2)*C + c].

The JAX package stores its folded matrices as int8 limb planes for the
TPU's matrix unit. The port keeps them as u64 mod-P matrices, BEFORE that
split: the CUDA kernels multiply natively in 64 bits. Every matrix, twiddle
and weight is the same element of GF(P) as the JAX table it replaces, and
every transform keeps the JAX's output order (DIF for a power-of-two
length, natural for the radix-5 r2 factor L2 = 5 * 2^b of n = 5 * 2^k),
so each stage boundary (and the spectral multiplicand) agrees with the JAX
pipeline mod P.

Tables built here, all canonical u64 numpy arrays unless noted:

  k1_mats (R2, L1, L1)  tr_fwd_w: DFT_L1 with row scale t_r and column
                        scale wr (the weights' r-part), one per r2
  g2      (L2, L2)      the generic forward r2 DFT (natural order at
                        L2 = 5 * 2^b)
  mf, mi  (R1, R2, C)   mid / mid_inv with the weights' ca-part and the
                        root-of-2 wrap folded in
  lane_f, lane_i (ca, ca)  the lane-tile DFT over ca = c >> 7
  Mf, Mi  (ca, 128, 128)   per-slot right-side matrices: omega_C twiddles
                        and the weights' lane part
  tri     (R1, L2, L2)  tr_inv: inverse r2 DFT with row scale t_r_inv
  k3_mats (R2, L1, L1)  iw_inv: inverse DFT_L1 with row scale iwr / n
  er (R1, R2), ec (C,)  u32 wrap residues: halve/double where er+ec >= n
  wt, cum (R1, R2, T, k)  u32 per-carry-unit spread widths / bit offsets
                        (T = carry_tiles units of carry_ct digits per row)
  widths  (R1, R2, C)   u32 digit widths
  bwt, bcum (R1, bk)    u32 spread widths / bit offsets of the block-carry
                        injection (the first bk digits of each r1 block)
  rounds, k8_rounds     the carry's ripple rounds: K3 and K7's rule, K8's

and, only when asked for (build_unfolded: the pass profiler and the tests,
never the engine), the unfolded tables of the JAX's `_forward_r` and
`_inverse_r` (UnfoldedTables below).

Which kernels a step runs follows the JAX pipeline's shape predicates
(use_rowcarry, use_xla_carry, use_r2fold, fc_split, carry_ct below); a
plan's `Pipeline` holds the budgets and switches they read, so the tests
can force every branch at small n as the JAX tests do with its
environment overrides.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import field
from ..core.plan import Plan

P = field.P
LANES = 128

_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)
_EPS = np.uint64(0xFFFFFFFF)
_P64 = np.uint64(P)


# ---------------------------------------------------------------------------
# numpy Goldilocks helpers (u64 arrays, canonical out)
# ---------------------------------------------------------------------------

def _reduce128(lo, hi):
    """(hi:lo) mod P with 2^64 = 2^32 - 1 and 2^96 = -1, canonical out."""
    hh = hi >> _S32
    hl = hi & _M32
    t0 = lo - hh
    t0 = np.where(lo < hh, t0 - _EPS, t0)
    t1 = hl * _EPS
    r = t0 + t1
    r = np.where(r < t0, r + _EPS, r)
    return np.where(r >= _P64, r - _P64, r)


def mulmod(a, b) -> np.ndarray:
    """Elementwise a*b mod P of u64 arrays (broadcasting)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    a0, a1 = a & _M32, a >> _S32
    b0, b1 = b & _M32, b >> _S32
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl
    mc = (mid < lh).astype(np.uint64)
    lo = ll + (mid << _S32)
    lc = (lo < ll).astype(np.uint64)
    hi = hh + (mid >> _S32) + (mc << _S32) + lc
    return _reduce128(lo, hi)


def pow_table(base: int, count: int) -> np.ndarray:
    """[base^0, base^1, ..., base^(count-1)] mod P by block doubling."""
    out = np.empty(count, dtype=np.uint64)
    out[0] = 1
    m = 1
    while m < count:
        step = min(m, count - m)
        out[m:m + step] = mulmod(out[:step], np.uint64(pow(base, m, P)))
        m += step
    return out


def powv(base: int, exps) -> np.ndarray:
    return np.array([pow(base, int(e), P) for e in exps], dtype=np.uint64)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

def root_554(m: int) -> int:
    """The m-th root of unity 554^((P-1)/m); 554^((P-1)/192) = 2, so every
    root of order m | 192 is a power of two (fourstep.py:42)."""
    assert (P - 1) % m == 0
    return pow(field.ROOT_TWO_BASE, (P - 1) // m, P)


def dif_freq_of_pos(L: int) -> np.ndarray:
    """Output order of the radix-2 DIF cascade: the frequency at position
    p is the bit reversal of p."""
    bits = L.bit_length() - 1
    out = np.zeros(L, dtype=np.int64)
    for p in range(L):
        f, x = 0, p
        for _ in range(bits):
            f = (f << 1) | (x & 1)
            x >>= 1
        out[p] = f
    return out


def shift_exponents(L1: int) -> list[tuple[int, list[int]]]:
    """Per DIF level (m, [e_j]): level half-size m has twiddles
    omega_{2m}^j = 2^(192/(2m) * j), j < m."""
    assert L1 <= 64 and 192 % max(2 * (L1 // 2), 1) == 0, \
        f"no shift-twiddle family for L={L1} (needs L | 64)"
    out = []
    m = L1 // 2
    while m >= 1:
        step = 192 // (2 * m)
        out.append((m, [step * j for j in range(m)]))
        m //= 2
    return out


@dataclasses.dataclass(eq=False)
class SplitSpec:
    """Column split L = L1 * L2: L1 on the slow axis, L2 on the next."""
    L: int
    L1: int
    L2: int
    freq1: np.ndarray
    freq2: np.ndarray

    @property
    def freq(self) -> np.ndarray:
        return self.freq1[:, None] + self.L1 * self.freq2[None, :]


def make_split(L: int) -> SplitSpec:
    if L & (L - 1) == 0:
        assert 4 <= L <= 16384, L
        L1 = min(L, 64)
        L2 = L // L1
        assert L2 <= 256, f"column length {L} too large for one kernel"
        return SplitSpec(L, L1, L2, dif_freq_of_pos(L1),
                         dif_freq_of_pos(L2))
    assert L % 5 == 0 and (L // 5) & (L // 5 - 1) == 0, L
    m = (L // 5).bit_length() - 1
    a = min(m, 6)
    L1 = 1 << a
    L2 = 5 << (m - a)
    assert L2 <= 320, f"column length {L} too large for one kernel"
    return SplitSpec(L, L1, L2, dif_freq_of_pos(L1),
                     np.arange(L2, dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """The budgets behind the JAX pipeline's branch choice, with its
    defaults: r2fold_max is PRMERS_R2FOLD_BUDGET (kernels.py:933), carry_max
    PRMERS_CARRY_BUDGET (:952), fc_split forces the split C-transform as
    PRMERS_FC_SPLIT does (:948), chain=False keeps the squarings off
    the whole-chain kernel K9 as PRMERS_NO_CHAIN does (:1901),
    rowcarry=False takes the block-carry pipeline (K4, the C-transform, K4
    inverse, K7) as PRMERS_NO_ROWCARRY does (:917), and xla_carry=True the
    canonical-digit hybrid (K4, the C-transform, K4 inverse, carry_full) as
    PRMERS_XLA_CARRY does (:987)."""
    r2fold_max: int = 1 << 19
    carry_max: int = 1 << 21
    fc_split: bool = False
    chain: bool = True
    rowcarry: bool = True
    xla_carry: bool = False


@dataclasses.dataclass(eq=False)
class FourStepPlan:
    """Kernel-level plan for n = R*C (fourstep.py:115-154)."""
    p: int
    n: int
    R: int
    C: int
    rs: SplitSpec
    cs: SplitSpec
    widths: np.ndarray
    max_word: int
    pipe: Pipeline = Pipeline()

    @classmethod
    def from_plan(cls, plan: Plan, pipe: Pipeline = Pipeline()):
        n = plan.n
        five = n % 5 == 0
        base = n // 5 if five else n
        assert base & (base - 1) == 0, \
            "four-step path requires n in {2^k, 5*2^k}"
        r_cap = 20480 if five else 4096
        C = 1024
        while n // C > r_cap and C < 8192:
            C *= 2
        R = n // C
        if not five and R > r_cap:
            r_cap = 8192
        assert 4 <= R <= r_cap, \
            f"transform out of range for the four-step path (n={n})"
        return cls(p=plan.p, n=n, R=R, C=C, rs=make_split(R),
                   cs=make_split(C), widths=plan.widths,
                   max_word=plan.max_word, pipe=pipe)

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.rs.L1, self.rs.L2, self.C)

    @property
    def ca_count(self) -> int:
        return self.C // LANES


# Shape predicates of the JAX pipeline (kernels.py:936-977), the budgets
# read from the plan's Pipeline instead of the environment.

def use_r2fold(fp: FourStepPlan) -> bool:
    """P2/P6 inside the C-transform kernel (K2) rather than as K5 passes."""
    return fp.rs.L2 * fp.C <= fp.pipe.r2fold_max


def fc_split(fp: FourStepPlan) -> bool:
    """The C-transform's forward and inverse halves as two kernels (K6
    "fwd", then K6b): at ca_count = 64, or when forced."""
    return fp.C // LANES > 32 or fp.pipe.fc_split


def _r2_tile(L2: int) -> int:
    """The JAX K1/K3 tile's r2 extent S (kernels.py:116)."""
    return 8 if L2 % 8 == 0 else L2


def carry_ct(fp: FourStepPlan) -> int:
    """Digits per carry unit: C, halved while the JAX K1/K3 tile
    (L1, S, CT) exceeds the carry budget (T = 2 at C = 8192)."""
    S = _r2_tile(fp.rs.L2)
    ct = fp.C
    while fp.rs.L1 * S * ct > fp.pipe.carry_max and ct % 256 == 0 \
            and ct > 256:
        ct //= 2
    return ct


def carry_tiles(fp: FourStepPlan) -> int:
    return fp.C // carry_ct(fp)


def use_xla_carry(fp: FourStepPlan) -> bool:
    """The canonical-digit hybrid (kernels.py:980-989): forced, or a carry
    tile (L1, S, carry_ct) over 2^22 elements, which no power-of-two plan
    of the port reaches."""
    return fp.pipe.xla_carry or \
        fp.rs.L1 * _r2_tile(fp.rs.L2) * carry_ct(fp) > (1 << 22)


def use_rowcarry(fp: FourStepPlan) -> bool:
    """The row-carry pipeline (K1, the C-transform, K3; kernels.py:910-917)
    unless the block-carry pipeline or the hybrid is asked for."""
    return fp.pipe.rowcarry and not use_xla_carry(fp)


# The JAX whole-chain kernel's VMEM cap: min(80 MiB, VMEM_LIMIT) with the
# default VMEM_LIMIT of 127 MiB (kernels.py:59, :1913).
CHAIN_VMEM = 80 * 1024 * 1024


def chain_ok(fp: FourStepPlan) -> bool:
    """Squarings through the whole-chain kernel K9 (kernels.py:1895-1913):
    the row-carry pipeline with whole-row carry units, L2 and ca = C / 128
    powers of two up to 8, and
    the JAX kernel's VMEM estimate under its cap; True exactly where the
    JAX package takes its chain (n = 2^15 ... 2^19 with the default
    pipeline)."""
    if not fp.pipe.chain or not use_rowcarry(fp) or carry_tiles(fp) != 1:
        return False
    L2 = fp.rs.L2
    ca = fp.C // LANES
    if L2 & (L2 - 1) or L2 > 8:
        return False
    if fp.C % LANES or ca & (ca - 1) or ca > 8:
        return False
    est = 10 * 4 * fp.n + 7 * 4 * fp.n + 2 * ca * (8 * 128) * (8 * 128)
    return est < CHAIN_VMEM


def carry_rounds(fp: FourStepPlan) -> int:
    """Ripple rounds of the carry phase of K3 and K7: split until the
    residual fits half the narrowest digit (kernels.py:681, :1411-1420)."""
    wmin = int(fp.widths.min())
    rounds = 1
    bound = fp.max_word * 4
    while bound >> (rounds * wmin) > (1 << max(wmin - 1, 1)):
        rounds += 1
    return max(rounds, 2)


def k8_rounds(fp: FourStepPlan) -> int:
    """Ripple rounds of K8, the mesh's block carry: split until the
    residual is at most 1 (sharded_pallas.py:209-215), more rounds than
    carry_rounds gives K7, so the lazy digits of the two differ."""
    wmin = int(fp.widths.min())
    rounds = 1
    bound = fp.max_word * 4
    while bound >> (rounds * wmin) > 1:
        rounds += 1
    return max(rounds, 2)


def _spread_plan(wmat: np.ndarray):
    """(k, wt, cum) for units that are the rows of wmat: the smallest k
    whose leading k digit widths cover >= 64 bits in every unit, those
    widths and their bit offsets, u32."""
    k = 1
    while int(wmat[:, :k].sum(axis=1).min()) < 64:
        k += 1
    wt = wmat[:, :k].astype(np.uint32)
    cum = np.zeros(wt.shape, dtype=np.uint32)
    cum[:, 1:] = np.cumsum(wt[:, :-1], axis=1)
    return k, wt, cum


def block_cin_plan(fp: FourStepPlan):
    """(k, wt, cum) of the block-carry injection (kernels.py:_cin_plan
    :1490-1502): the first k digit widths of each r1 block of n / R1
    digits and their bit offsets, (R1, k) u32."""
    return _spread_plan(fp.widths.reshape(fp.rs.L1, -1).astype(np.int64))


def row_cin_plan(fp: FourStepPlan):
    """(k, wt, cum): each carry unit's spread widths and bit offsets,
    (R1, R2, T, k) u32 (kernels.py:702, without the 128-lane padding that
    Mosaic's block rule needs there)."""
    k, wt, cum = _spread_plan(
        fp.widths.reshape(-1, carry_ct(fp)).astype(np.int64))
    sh = (fp.rs.L1, fp.rs.L2, carry_tiles(fp), k)
    return k, wt.reshape(sh), cum.reshape(sh)


def cin_row_k(fp: FourStepPlan) -> int:
    """Spread parts per carry unit: the smallest k whose leading k digit
    widths cover >= 64 bits in every unit of carry_ct digits
    (kernels.py:690)."""
    return row_cin_plan(fp)[0]


# ---------------------------------------------------------------------------
# DFT matrices
# ---------------------------------------------------------------------------

def dft_matrix(L: int, inverse: bool) -> np.ndarray:
    """(L, L) u64 DFT matrix of mxu_dft.dft_matrix (:53-92, closed form).
    A power-of-two L keeps the DIF order of fourstep.dft_axis0. Forward:
    output position k holds frequency freq(k), M[k][j] = w^(freq(k) * j).
    Inverse (mirrored DIT, consumes the forward order, natural out):
    M[k][j] = w^(-k * freq(j)). Any other L (the radix-5 r2 factors L2 =
    5 * 2^b, which the JAX runs only as MXU matrices) is the natural-order
    Vandermonde M[k][j] = w^(k * j), with w inverted for the inverse."""
    w = root_554(L)
    if inverse:
        w = field.inv(w)
    pw = pow_table(w, L)
    k = np.arange(L, dtype=np.int64)
    if L & (L - 1):
        return pw[(k[:, None] * k[None, :]) % L]
    freq = dif_freq_of_pos(L)
    if not inverse:
        e = (freq[:, None] * k[None, :]) % L
    else:
        e = (k[:, None] * freq[None, :]) % L
    return pw[e]


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class FourStepTables:
    """Base tables (fourstep.py:230-303, numpy only): the R-pass T layer
    t_r / t_r_inv (R1, R2) and the mid layer mid / mid_inv (R1, R2, C)."""
    fp: FourStepPlan
    t_r: np.ndarray
    t_r_inv: np.ndarray
    mid: np.ndarray
    mid_inv: np.ndarray

    @classmethod
    def build(cls, fp: FourStepPlan):
        n, R, C = fp.n, fp.R, fp.C
        R1, R2 = fp.rs.L1, fp.rs.L2
        wR = root_554(R)
        f1 = np.asarray(fp.rs.freq1, dtype=np.int64)
        r2 = np.arange(R2, dtype=np.int64)
        e_tr = (f1[:, None] * r2[None, :]) % R
        pr = pow_table(wR, R)
        t_r = pr[e_tr]
        t_r_inv = pr[(-e_tr) % R]
        # mid: omega_n^(c * kR(r)); one power table of omega_n, gathered
        kR = np.asarray(fp.rs.freq.reshape(R), dtype=np.int64)
        c = np.arange(C, dtype=np.int64)
        e_mid = ((kR[:, None] % n) * c[None, :]) % n
        pn = pow_table(root_554(n), n)
        mid = pn[e_mid].reshape(R1, R2, C)
        mid_inv = pn[(-e_mid) % n].reshape(R1, R2, C)
        return cls(fp=fp, t_r=t_r, t_r_inv=t_r_inv, mid=mid,
                   mid_inv=mid_inv)


@dataclasses.dataclass(eq=False)
class KernelTables:
    """Everything the port's kernels read (see the module docstring)."""
    fp: FourStepPlan
    k1_mats: np.ndarray
    g2: np.ndarray
    mf: np.ndarray
    mi: np.ndarray
    lane_f: np.ndarray
    lane_i: np.ndarray
    Mf: np.ndarray
    Mi: np.ndarray
    tri: np.ndarray
    k3_mats: np.ndarray
    er: np.ndarray
    ec: np.ndarray
    wt: np.ndarray
    cum: np.ndarray
    widths: np.ndarray
    k: int
    ct: int
    rounds: int
    bwt: np.ndarray
    bcum: np.ndarray
    bk: int
    k8_rounds: int


def _fold_rows(M: np.ndarray, row_scale: np.ndarray,
               col_scale: np.ndarray | None = None) -> np.ndarray:
    """Variants diag(row_scale[v]) @ M @ diag(col_scale[v]):
    (V, L) scales -> (V, L, L) (mxu_dft.build_mxu_tables' fold)."""
    Mk = mulmod(row_scale[:, :, None], M[None])
    if col_scale is not None:
        Mk = mulmod(Mk, col_scale[:, None, :])
    return Mk


def fused_c_mats(fp: FourStepPlan):
    """Per-slot right-side matrices Mf/Mi (ca, 128, 128), out[b, k] =
    sum_l x[b, l] * M[l, k], and the per-column folds of the mids
    (fourstep.py:602-722 before the int8 split)."""
    n, C = fp.n, fp.C
    ca = fp.ca_count
    assert C % LANES == 0 and 2 <= ca <= 64 and ca & (ca - 1) == 0, \
        f"no fused C-transform for C={C}"
    pn = fp.p % n
    wC = root_554(C)
    nr2 = field.root_two_nth(n)
    nr2i = field.inv(nr2)
    wpow = pow_table(wC, C)
    wipow = pow_table(field.inv(wC), C)
    ecl = np.array([(-pn * ll) % n for ll in range(LANES)], dtype=np.int64)
    eca = np.array([(-pn * LANES * j) % n for j in range(ca)],
                   dtype=np.int64)
    wcl = powv(nr2, ecl)
    iwcl = powv(nr2i, ecl)
    freqs = dif_freq_of_pos(ca)
    ll = np.arange(LANES, dtype=np.int64)
    Mf = np.empty((ca, LANES, LANES), dtype=np.uint64)
    Mi = np.empty((ca, LANES, LANES), dtype=np.uint64)
    for j in range(ca):
        kl = int(freqs[j])
        e = (ll[:, None] * (kl + ca * ll[None, :])) % C
        Mf[j] = mulmod(wpow[e], wcl[:, None])
        ei = (ll[None, :] * (kl + ca * ll[:, None])) % C
        Mi[j] = mulmod(wipow[ei], iwcl[None, :])
    # the root-of-2 wrap between the ca / lane exponent parts, folded
    # into the mids as 1/2 (forward) and 2 (inverse)
    wrap = (np.repeat(eca, LANES) + np.tile(ecl, ca)) >= n
    wfac = np.where(wrap, np.uint64(field.inv(2)), np.uint64(1))
    ifac = np.where(wrap, np.uint64(2), np.uint64(1))
    wca_c = mulmod(np.repeat(powv(nr2, eca), LANES), wfac)
    iwca_c = mulmod(np.repeat(powv(nr2i, eca), LANES), ifac)
    return Mf, Mi, wca_c, iwca_c


def build_tables(fp: FourStepPlan) -> KernelTables:
    """All of the port's kernel tables for one plan (numpy, host)."""
    assert fp.rs.L1 >= 32, "weight folds need rs.L1 >= 32"
    assert int(fp.widths.max()) < 32, "digit widths must fit one u32 word"
    base = FourStepTables.build(fp)
    n, R, C = fp.n, fp.R, fp.C
    R1, R2 = fp.rs.L1, fp.rs.L2
    pn = fp.p % n

    # IBDWT weight r-part: w(r*C + c) = wr(r) * wc(c) * 2^-k, k the wrap
    er = np.array([(-pn * r * C) % n for r in range(R)], dtype=np.int64)
    ec = np.array([(-pn * c) % n for c in range(C)], dtype=np.int64)
    nr2 = field.root_two_nth(n)
    wr = powv(nr2, er)
    iwr = mulmod(powv(field.inv(nr2), er), np.uint64(field.inv(n)))

    d1f = dft_matrix(R1, False)
    d1i = dft_matrix(R1, True)
    k1_mats = _fold_rows(d1f, base.t_r.T.copy(),
                         wr.reshape(R1, R2).T.copy())
    k3_mats = _fold_rows(d1i, iwr.reshape(R1, R2).T.copy())
    g2 = dft_matrix(R2, False)
    tri = _fold_rows(dft_matrix(R2, True), base.t_r_inv)

    Mf, Mi, wca_c, iwca_c = fused_c_mats(fp)
    mf = mulmod(base.mid, wca_c.reshape(1, 1, C))
    mi = mulmod(base.mid_inv, iwca_c.reshape(1, 1, C))

    k, wt, cum = row_cin_plan(fp)
    bk, bwt, bcum = block_cin_plan(fp)
    return KernelTables(
        fp=fp, k1_mats=k1_mats, g2=g2, mf=mf, mi=mi,
        lane_f=dft_matrix(fp.ca_count, False),
        lane_i=dft_matrix(fp.ca_count, True),
        Mf=Mf, Mi=Mi, tri=tri, k3_mats=k3_mats,
        er=er.reshape(R1, R2).astype(np.uint32),
        ec=ec.astype(np.uint32),
        wt=wt, cum=cum,
        widths=fp.widths.reshape(R1, R2, C).astype(np.uint32),
        k=k, ct=carry_ct(fp), rounds=carry_rounds(fp), bwt=bwt, bcum=bcum,
        bk=bk, k8_rounds=k8_rounds(fp))


# ---------------------------------------------------------------------------
# The unfolded tables (the JAX's _forward_r / _inverse_r forms)
# ---------------------------------------------------------------------------

def has_matrix(L: int) -> bool:
    """Whether the JAX builds a generic matrix for a length-L factor
    (attach_mxu_tables, fourstep.py:803-810): from L = 32 on, and always
    for a radix-5 factor; the shorter power-of-two factors run only as
    shift-twiddle butterflies."""
    return L >= 32 or L & (L - 1) != 0


@dataclasses.dataclass(eq=False)
class UnfoldedTables:
    """The tables of the unfolded passes, canonical u64 unless noted, as
    the JAX's FourStepTables.build and attach_mxu_tables make them:

      w, iw        (R1, R2, C)  the IBDWT weights, and their inverses x 1/n
      t_r, t_r_inv (R1, R2, 1)  the R-pass T layer, broadcast over lanes
      mid, mid_inv (R1, R2, C)  omega_n^(+-c * kR)
      tr_fwd  (R2, L1, L1)  DFT_L1 with row scale t_r^T, one per r2
                            ("tr_fwd", fourstep.py:818-819)
      d1i     (L1, L1)      the inverse r1 DFT ((L1, True), :810)
      g2      (L2, L2)      the forward r2 DFT ((L2, False), :810)
      tri     (R1, L2, L2)  the inverse r2 DFT with row scale t_r_inv, one
                            per r1 ("tr_inv", :820-821)
      cin_widths (k,) u32   the leading digit widths that cover 64 bits,
                            the scalar injection's spread (kernels.py:1463)

    A matrix the JAX does not build (has_matrix False) is None: that
    factor runs as shift butterflies in both forms, as `_mx` finds no
    table for it."""
    fp: FourStepPlan
    w: np.ndarray
    iw: np.ndarray
    t_r: np.ndarray
    t_r_inv: np.ndarray
    mid: np.ndarray
    mid_inv: np.ndarray
    tr_fwd: np.ndarray | None
    d1i: np.ndarray | None
    g2: np.ndarray | None
    tri: np.ndarray | None
    cin_widths: np.ndarray


def cin_widths(fp: FourStepPlan) -> np.ndarray:
    """The widths of the leading digits whose sum first reaches 64 bits
    (kernels.py:_cin_widths :1463-1468), u32."""
    acc = np.cumsum(fp.widths.astype(np.int64))
    k = int(np.searchsorted(acc, 64)) + 1
    return fp.widths[:k].astype(np.uint32)


def build_unfolded(fp: FourStepPlan) -> UnfoldedTables:
    """The unfolded tables of a plan (host numpy; four n-word tables, 256
    MiB at n = 2^23)."""
    base = FourStepTables.build(fp)
    n, R1, R2, C = fp.n, fp.rs.L1, fp.rs.L2, fp.C
    e_w = (-(fp.p % n) * np.arange(n, dtype=np.int64)) % n
    nr2 = field.root_two_nth(n)
    w = pow_table(nr2, n)[e_w]
    iw = mulmod(pow_table(field.inv(nr2), n)[e_w],
                np.uint64(field.inv(n)))
    L1, L2 = R1, R2
    return UnfoldedTables(
        fp=fp, w=w.reshape(R1, R2, C), iw=iw.reshape(R1, R2, C),
        t_r=base.t_r.reshape(R1, R2, 1),
        t_r_inv=base.t_r_inv.reshape(R1, R2, 1),
        mid=base.mid, mid_inv=base.mid_inv,
        tr_fwd=(_fold_rows(dft_matrix(L1, False), base.t_r.T.copy())
                if has_matrix(L1) else None),
        d1i=dft_matrix(L1, True) if has_matrix(L1) else None,
        g2=dft_matrix(L2, False) if has_matrix(L2) else None,
        tri=(_fold_rows(dft_matrix(L2, True), base.t_r_inv)
             if has_matrix(L2) else None),
        cin_widths=cin_widths(fp))
