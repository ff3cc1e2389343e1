"""Paired GF(M31^2) x GF(M61^2) IBDWT NTT — the second arithmetic path.

TPU analog of the reference's Aevum "FFT3161" backend (reference:
third_party/aevum/src/FFTConfig.h:24 FFT3161 type, Gpu.cpp square pipeline
:2987-3035, math.cl GF31/GF61 arithmetic :618-640): the same integer
convolution is computed mod M31 and mod M61 in the quadratic extensions
(where 2^k- and 3^a-order roots exist), and the ~92-bit CRT combination
doubles the usable bits-per-word over Goldilocks — roughly half the
transform size for the same exponent.

v1 is the XLA/numpy correctness path (one full-length DIF column transform
per plane, generic radix-2/3/4 butterflies over (re, im) pairs); the
Pallas kernel set follows the same structure later. Supported sizes:
n = 2^k, 3*2^k, 9*2^k.

Port: a copy of prmers_tpu/ops/ntt2.py. LOG2_CRT, the capacity functions
(max_bpw_3161, max_exponent_3161, shape_table_3161, transform_size_3161),
radix_seq_23, PlaneTables/Tables3161 and _build_plane/build_tables are
the JAX package's verbatim, and so are the transforms on numpy (the host
oracle of engine/engine3161.py, xp=np) but for carry_3161's jax branch.
The listed changes:
  * build_tables takes `fast` (default True): _build_plane_fast gives the
    same tables bit for bit (tests/test_torch_ntt2.py holds them against
    the copied scalar loops) in vectorized numpy, each stage's twiddles
    as powers of its root indexed by s*j and (L - s*j) mod L (the
    inverse, with no F.inv per entry), the weights as powers of two. The
    scalar loops take ~215 s at n = 2^22, the fast build seconds.
  * DevTables3161 carries the tables to a torch device: each plane's
    (re, im) pairs stacked as (2, ...) tensors, the M31 plane int32 (a
    canonical value is below 2^31 - 1) and the M61 plane int64.
  * fwd_stage_plain, inv_stage_plain and pointwise_plain are the plain
    torch versions of the kernels K10-K12 (csrc/f3_ntt.cu, wrapped in
    ops/kernels.py): one DIF stage of plane_fwd on both planes (the first
    also folds norm(d) x weights, as forward_3161 does), one DIT stage of
    plane_inv (the last also folds unweights, takes the real part and
    does inverse_3161's CRT to the exact (lo, hi)), and sqr or mul by a
    multiplicand's planes. They compute on core.field2.Fq2Torch, so
    every stage's output is canonical and equal to the reference's.
  * carry is carry_3161 in torch: the split of the 92-bit (lo, hi) (the
    shift of lo masked, for torch's >> on int64 is arithmetic), the
    multiplier, then ops/carry.settle with a static count of absorb
    rounds (no loop that reads the data, so an op can be a CUDA graph).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np

import torch

from ..core import field2
from ..core.field2 import F31, F61, T31, T61, Fq2, Fq2Ops, M31, M61
from ..core.plan import digit_widths
from . import carry as carry_ops

LOG2_CRT = 91.99   # log2(M31 * M61), safely rounded down


def max_bpw_3161(n: int) -> int:
    """Per-shape capacity: the largest MEAN bits-per-word w = floor(p/n)
    the shape supports — the fftbpw analog of the reference
    (third_party/aevum FFTConfig.h:70-106 / fftbpw.h per-shape BPW
    tables). Exact-NTT version: the convolution bound
    2*(w+1) + log2 n < log2(M31*M61) with w+1 the max digit width
    (IBDWT ceil-split digits are at most one bit over the mean); no
    round-off-error tables are needed because the arithmetic is exact."""
    import math
    return int((LOG2_CRT - math.log2(n)) / 2 - 1)


def max_exponent_3161(n: int) -> int:
    """Largest exponent the shape n supports (capacity boundary)."""
    return n * (max_bpw_3161(n) + 1) - 1


def shape_table_3161(max_k: int = 27) -> list[tuple[int, int, int]]:
    """Sorted (n, max_bpw, max_exponent) rows for every supported shape
    n in {2^k, 3*2^k, 9*2^k}, n >= 8 — the inspectable per-shape plan
    table (reference: aevum FFT config enumeration, FFTConfig.h:24)."""
    rows = []
    for odd in (1, 3, 9):
        for k in range(1, max_k + 1):
            n = odd << k
            if n >= 8:
                rows.append((n, max_bpw_3161(n), max_exponent_3161(n)))
    rows.sort()
    return rows


def transform_size_3161(p: int) -> int:
    """Smallest n in {2^k, 3*2^k, 9*2^k} with p within the shape's BPW
    capacity (max_exponent_3161)."""
    for n, _bpw, pmax in shape_table_3161(40):
        if p <= pmax:
            return max(n, 8)
    raise ValueError("exponent too large")


def radix_seq_23(length: int) -> tuple[int, ...]:
    """DIF stage radices for n = 3^a * 2^k (a <= 2)."""
    seq = []
    L = length
    while L % 3 == 0:
        seq.append(3)
        L //= 3
    k = L.bit_length() - 1
    assert L == 1 << k, f"invalid 3161 length {length}"
    if k % 2 == 1:
        seq.append(2)
        k -= 1
    seq.extend([4] * (k // 2))
    return tuple(seq)


@dataclasses.dataclass
class PlaneTables:
    """Per-field tables (all arrays are (re, im) u64 pairs)."""
    q: int
    s: int
    stages: Any          # list of (radix, tw_pair (r, m), twi_pair)
    dmat: Any            # {r: ((r, r) pair, (r, r) inverse pair)}
    weights: Any         # (n,) pair
    unweights: Any       # (n,) pair, includes 1/n


@dataclasses.dataclass
class Tables3161:
    p: int
    n: int
    widths: Any          # (n,) u64
    masks: Any           # (n,) u64
    p31: PlaneTables
    p61: PlaneTables
    crt_minv: int        # q31^-1 mod q61


def _pairs(xp, vals):
    re = xp.asarray(np.array([v[0] for v in vals], dtype=np.uint64))
    im = xp.asarray(np.array([v[1] for v in vals], dtype=np.uint64))
    return re, im


def _build_plane(F: Fq2, xp, p: int, n: int) -> PlaneTables:
    radixes = radix_seq_23(n)
    # stage twiddles, mirroring ntt.build_stages: at stage (radix r over
    # length L), tw[s, j] = w_L^(s * j) for j < m = L/r
    stages = []
    L = n
    while L > 1:
        r = radixes[len(stages)]
        m = L // r
        wL = F.root_unity(L)
        rows = []
        for s in range(r):
            base = F.pow(wL, s)
            acc = (1, 0)
            row = []
            for _ in range(m):
                row.append(acc)
                acc = F.mul(acc, base)
            rows.append(row)
        tw = _pairs(xp, [v for row in rows for v in row])
        twi = _pairs(xp, [F.inv(v) for row in rows for v in row])
        stages.append((r, (tw[0].reshape(r, m), tw[1].reshape(r, m)),
                       (twi[0].reshape(r, m), twi[1].reshape(r, m))))
        L = m
    # small DFT matrices per radix
    dmat = {}
    for r in set(radixes):
        wr = F.root_unity(r)
        fwd = [F.pow(wr, (s * t) % r) for s in range(r) for t in range(r)]
        inv = [F.inv(v) for v in fwd]
        f = _pairs(xp, fwd)
        i = _pairs(xp, inv)
        dmat[r] = ((f[0].reshape(r, r), f[1].reshape(r, r)),
                   (i[0].reshape(r, r), i[1].reshape(r, r)))
    # IBDWT weights: w_j = r2^((n - (p*j mod n)) mod n), r2^n = 2
    r2 = F.root_two(n)
    r2i = F.inv(r2)
    ninv = F.inv((n % F.q, 0))
    ws = []
    uws = []
    for j in range(n):
        e = (n - (p * j) % n) % n
        ws.append(F.pow(r2, e))
        uws.append(F.mul(F.pow(r2i, e), ninv))
    return PlaneTables(q=F.q, s=F.s, stages=stages, dmat=dmat,
                       weights=_pairs(xp, ws), unweights=_pairs(xp, uws))


@functools.lru_cache(maxsize=4)
def _tables_np(p: int, n: int) -> "Tables3161":
    return build_tables(p, n, np)


def build_tables(p: int, n: int | None, xp, fast: bool = True) -> Tables3161:
    if n is None:
        n = transform_size_3161(p)
    widths = digit_widths(p, n)
    masks = (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
    plane = _build_plane_fast if fast else _build_plane
    return Tables3161(
        p=p, n=n,
        widths=xp.asarray(widths.astype(np.uint64)),
        masks=xp.asarray(masks),
        p31=plane(F31, xp, p, n),
        p61=plane(F61, xp, p, n),
        crt_minv=field2.Q31_INV_MOD_Q61,
    )


def _powers(F: Fq2, base, count: int):
    """base^j for j < count as (re, im) u64 arrays: the run so far times
    base^len, doubling its length each step."""
    ops = Fq2Ops(np, F.q, F.s)
    re = np.ones(1, dtype=np.uint64)
    im = np.zeros(1, dtype=np.uint64)
    while re.size < count:
        sr, si = F.pow(base, re.size)
        nr, ni = ops.mul((re, im), (np.uint64(sr), np.uint64(si)))
        re, im = np.concatenate([re, nr]), np.concatenate([im, ni])
    return re[:count], im[:count]


def _build_plane_fast(F: Fq2, xp, p: int, n: int) -> PlaneTables:
    """_build_plane's tables in vectorized numpy. Stage (r, L): tw[s, j]
    = w_L^(s j) and twi[s, j] = w_L^(L - s j) (w_L^L = 1, s j < L), both
    read from the powers of w_L. Weights: r2 = 2^a lies in the base field,
    so r2^e = 2^(a e mod s), and r2^-e / n = 2^(k e mod s) / n for r2^-1 =
    2^k."""
    ops = Fq2Ops(np, F.q, F.s)
    radixes = radix_seq_23(n)
    stages = []
    L = n
    while L > 1:
        r = radixes[len(stages)]
        m = L // r
        wre, wim = _powers(F, F.root_unity(L), L)
        sj = np.arange(r, dtype=np.int64)[:, None] * np.arange(m)[None, :]
        isj = (L - sj) % L
        stages.append((r, (xp.asarray(wre[sj]), xp.asarray(wim[sj])),
                       (xp.asarray(wre[isj]), xp.asarray(wim[isj]))))
        L = m
    dmat = {}
    for r in set(radixes):
        wr = F.root_unity(r)
        fwd = [F.pow(wr, (s * t) % r) for s in range(r) for t in range(r)]
        inv = [F.inv(v) for v in fwd]
        f = _pairs(xp, fwd)
        i = _pairs(xp, inv)
        dmat[r] = ((f[0].reshape(r, r), f[1].reshape(r, r)),
                   (i[0].reshape(r, r), i[1].reshape(r, r)))
    r2 = F.root_two(n)
    r2i = F.inv(r2)
    ninv = F.inv((n % F.q, 0))
    a, k = r2[0].bit_length() - 1, r2i[0].bit_length() - 1
    assert (r2, r2i) == ((1 << a, 0), (1 << k, 0)) and ninv[1] == 0
    e = (n - (p % n) * np.arange(n, dtype=np.int64) % n) % n
    one = np.uint64(1)
    ws = one << ((a * e) % F.s).astype(np.uint64)
    uws = ops.mulq(one << ((k * e) % F.s).astype(np.uint64),
                   np.uint64(ninv[0]))
    zero = np.zeros(n, dtype=np.uint64)
    return PlaneTables(q=F.q, s=F.s, stages=stages, dmat=dmat,
                       weights=(xp.asarray(ws), xp.asarray(zero)),
                       unweights=(xp.asarray(uws), xp.asarray(zero.copy())))


# ---------------------------------------------------------------------------
# Transforms (x is an (re, im) pair of (n,) u64 arrays)
# ---------------------------------------------------------------------------

def _apply_dft(ops: Fq2Ops, parts, mat):
    """outs[s] = sum_t mat[s, t] * parts[t] (r x r small DFT)."""
    r = len(parts)
    mre, mim = mat
    is_np = ops.xp is np  # the ones-shortcut needs concrete entries
    outs = []
    for s in range(r):
        acc = None
        for t in range(r):
            if is_np and (int(mre[s, t]), int(mim[s, t])) == (1, 0):
                term = parts[t]
            else:
                term = ops.mul((mre[s, t], mim[s, t]), parts[t])
            acc = term if acc is None else ops.add(acc, term)
        outs.append(acc)
    return outs


def _neg_pair(ops: Fq2Ops, x):
    zero = ops.xp.uint64(0) * x[0]
    return ops.subq(zero, x[0]), ops.subq(zero, x[1])


@functools.lru_cache(maxsize=None)
def _w4_is_i(q: int) -> bool:
    """Whether the consistent root family's w_4 is +i (else it is -i).
    The radix-4 butterfly needs the concrete unit at trace time; the
    dmat tables carry it only as traced arrays."""
    F = field2.F31 if q == field2.M31 else field2.F61
    w4 = F.root_unity(4)
    assert w4 in ((0, 1), (0, q - 1)), w4
    return w4 == (0, 1)


@functools.lru_cache(maxsize=None)
def _w3_pair(q: int, inverse: bool):
    """root_unity(3) (or its inverse) as concrete ints for the radix-3
    butterfly — same consistent root family as the dmat tables."""
    F = field2.F31 if q == field2.M31 else field2.F61
    w = F.root_unity(3)
    return F.inv(w) if inverse else w


def _bfly(ops: Fq2Ops, parts, inverse: bool):
    """Radix-2/3/4 DFT without the r x r general-multiply matrix.

    Radix 2/4: every matrix entry is a unit (1, -1, ±i) — adds/subs and
    mul_i only. Radix 3 (Winograd): with w^2 = -1 - w,
      out1 = (x0 - x2) + w(x1 - x2),  out2 = (x0 - x1) - w(x1 - x2),
    i.e. ONE general multiply. All bit-exact equal to _apply_dft with
    dmat (same root family); far smaller XLA graphs."""
    xp = ops.xp
    r = len(parts)
    if r == 2:
        x0, x1 = parts
        return [ops.add(x0, x1), ops.sub(x0, x1)]
    if r == 3:
        x0, x1, x2 = parts
        wr, wi = _w3_pair(ops.q, inverse)
        m = ops.mul((xp.uint64(wr), xp.uint64(wi)), ops.sub(x1, x2))
        out0 = ops.add(x0, ops.add(x1, x2))
        out1 = ops.add(ops.sub(x0, x2), m)
        out2 = ops.sub(ops.sub(x0, x1), m)
        return [out0, out1, out2]
    assert r == 4, r
    x0, x1, x2, x3 = parts
    a = ops.add(x0, x2)
    b = ops.sub(x0, x2)
    c = ops.add(x1, x3)
    d = ops.sub(x1, x3)
    wd = ops.mul_i(d)
    if _w4_is_i(ops.q) == inverse:      # w (fwd) vs w^-1 = -w (inv)
        wd = _neg_pair(ops, wd)
    return [ops.add(a, c), ops.add(b, wd), ops.sub(a, c), ops.sub(b, wd)]


def plane_fwd(ops: Fq2Ops, x, pt: PlaneTables):
    """DIF forward along the (n,) axis; output frequency-scrambled."""
    xp = ops.xp
    n = x[0].shape[0]
    B, L = 1, n
    re, im = x
    for (r, tw, _) in pt.stages:
        m = L // r
        vre = re.reshape(B, r, m)
        vim = im.reshape(B, r, m)
        parts = [(vre[:, t], vim[:, t]) for t in range(r)]
        if r in (2, 3, 4):
            outs = _bfly(ops, parts, inverse=False)
        else:
            outs = _apply_dft(ops, parts, pt.dmat[r][0])
        # twiddle output row s by tw[s] (row 0 is ones)
        tre, tim = tw
        outs = [outs[0]] + [
            ops.mul((tre[s][None, :], tim[s][None, :]), outs[s])
            for s in range(1, r)]
        re = xp.stack([o[0] for o in outs], axis=1).reshape(B * r, m)
        im = xp.stack([o[1] for o in outs], axis=1).reshape(B * r, m)
        B *= r
        L = m
    return re.reshape(n), im.reshape(n)


def plane_inv(ops: Fq2Ops, x, pt: PlaneTables):
    """DIT inverse consuming plane_fwd's ordering."""
    xp = ops.xp
    n = x[0].shape[0]
    re, im = x
    dims = []
    L = n
    for (r, _, _) in pt.stages:
        dims.append((L, r))
        L //= r
    for (r, _, twi), (Lcur, _) in zip(reversed(pt.stages), reversed(dims)):
        m = Lcur // r
        B = n // Lcur
        vre = re.reshape(B, r, m)
        vim = im.reshape(B, r, m)
        tre, tim = twi
        parts = [(vre[:, 0], vim[:, 0])] + [
            ops.mul((tre[s][None, :], tim[s][None, :]), (vre[:, s], vim[:, s]))
            for s in range(1, r)]
        if r in (2, 3, 4):
            outs = _bfly(ops, parts, inverse=True)
        else:
            outs = _apply_dft(ops, parts, pt.dmat[r][1])
        re = xp.stack([o[0] for o in outs], axis=1).reshape(B * r * m)
        im = xp.stack([o[1] for o in outs], axis=1).reshape(B * r * m)
    return re, im


def plane_square_spectral(ops: Fq2Ops, s):
    return ops.sqr(s)


def forward_3161(ops31: Fq2Ops, ops61: Fq2Ops, t: Tables3161, d):
    """Digits (n,) u64 -> spectral pairs ((re31, im31), (re61, im61))."""
    xp = ops31.xp
    d31 = ops31.norm(d)
    d61 = ops61.norm(d)
    z = xp.zeros_like(d)
    x31 = ops31.mul(t.p31.weights, (d31, z))
    x61 = ops61.mul(t.p61.weights, (d61, z))
    return plane_fwd(ops31, x31, t.p31), plane_fwd(ops61, x61, t.p61)


def inverse_3161(ops31: Fq2Ops, ops61: Fq2Ops, t: Tables3161, s31, s61):
    """Spectral pairs -> CRT-combined coefficients (lo64, hi) u64 pairs."""
    xp = ops31.xp
    y31 = plane_inv(ops31, s31, t.p31)
    y61 = plane_inv(ops61, s61, t.p61)
    c31 = ops31.mul(t.p31.unweights, y31)[0]   # im must vanish
    c61 = ops61.mul(t.p61.unweights, y61)[0]
    # CRT: v = c31 + q31 * ((c61 - c31) * q31^-1 mod q61)
    diff = ops61.subq(c61, ops61.norm(c31))
    tmul = ops61.mulq(diff, xp.uint64(t.crt_minv % M61))
    # v = c31 + M31 * tmul  (tmul < 2^61): 64x61-bit product as (lo, hi)
    M32 = xp.uint64(0xFFFFFFFF)
    a0 = tmul & M32
    a1 = tmul >> xp.uint64(32)
    q31 = xp.uint64(M31)
    p0 = a0 * q31                      # < 2^63
    p1 = a1 * q31                      # < 2^60
    lo = c31 + p0                      # < 2^64? c31 < 2^31, p0 < 2^63 ok
    mid = p1 + (lo >> xp.uint64(32))
    lo = (lo & M32) | ((mid & M32) << xp.uint64(32))
    hi = mid >> xp.uint64(32)
    return lo, hi


def carry_3161(xp, lo, hi, widths, masks, a=1):
    """Exact digit normalization of CRT coefficients (lo, hi < 2^28);
    optional small multiplier a < 2^16 folded before propagation (same
    adc_mul decomposition as the Goldilocks carry)."""
    w = widths
    d = lo & masks
    # carry = v >> w  (v < n * 2^(2w+2) so carry fits u64)
    c = (lo >> w) | (hi << (xp.uint64(64) - w))
    if not (isinstance(a, int) and a == 1):
        a64 = xp.uint64(a) if isinstance(a, int) else a
        t = d * a64
        c = c * a64 + (t >> w)
        d = t & masks

    def inject(c, d):
        c = xp.roll(c, 1)
        t = d + c
        return t >> w, t & masks

    c, d = inject(c, d)
    while bool((c != 0).any()):
        c, d = inject(c, d)
    return d


# ---------------------------------------------------------------------------
# The tables on a torch device, and the plain versions of K10-K12
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class StageT:
    """One stage of the transform: radix r at length L = r m over B = n / L
    blocks; each twiddle table (2, r, m) holds its re and im parts."""
    r: int
    L: int
    m: int
    B: int
    tw31: torch.Tensor
    twi31: torch.Tensor
    tw61: torch.Tensor
    twi61: torch.Tensor


def _dev_pair(pair, dtype, device) -> torch.Tensor:
    a = np.stack([np.asarray(pair[0]), np.asarray(pair[1])])
    if dtype == torch.int32:
        return torch.from_numpy(a.astype(np.int32)).to(device)
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


@dataclasses.dataclass(eq=False)
class DevTables3161:
    """Tables3161 on a device: the stages in forward order, the (2, n)
    weights and unweights of each plane (M31 int32, M61 int64), the
    widths and masks as int64."""
    p: int
    n: int
    stages: list
    w31: torch.Tensor
    w61: torch.Tensor
    uw31: torch.Tensor
    uw61: torch.Tensor
    widths: torch.Tensor
    masks: torch.Tensor
    wmin: int
    wmax: int

    @classmethod
    def from_host(cls, t: Tables3161, device) -> "DevTables3161":
        i32, i64 = torch.int32, torch.int64
        stages = []
        B = 1
        for (r, tw31, twi31), (_, tw61, twi61) in zip(t.p31.stages,
                                                      t.p61.stages):
            m = tw31[0].shape[1]
            stages.append(StageT(r, r * m, m, B,
                                 _dev_pair(tw31, i32, device),
                                 _dev_pair(twi31, i32, device),
                                 _dev_pair(tw61, i64, device),
                                 _dev_pair(twi61, i64, device)))
            B *= r
        w = np.asarray(t.widths)
        return cls(p=t.p, n=t.n, stages=stages,
                   w31=_dev_pair(t.p31.weights, i32, device),
                   w61=_dev_pair(t.p61.weights, i64, device),
                   uw31=_dev_pair(t.p31.unweights, i32, device),
                   uw61=_dev_pair(t.p61.unweights, i64, device),
                   widths=torch.from_numpy(w.astype(np.int64)).to(device),
                   masks=torch.from_numpy(np.asarray(t.masks).view(
                       np.int64).copy()).to(device),
                   wmin=int(w.min()), wmax=int(w.max()))

    @property
    def device(self) -> torch.device:
        return self.widths.device

    def rounds(self, a: int = 1, bound: int | None = None) -> int:
        """Absorb rounds after which carry leaves every carry 0 or 1, for
        coefficients below bound (default the convolution's, n 2^(2
        wmax)) times a. The split leaves carries of at most C = (bound -
        1) a >> wmin, and a round takes a carry C to at most
        ceil(C / 2^wmin) (digit below 2^w plus carry, over 2^w), so the
        count is tight: the top coefficient needs them all
        (tests/test_torch_ntt2.py)."""
        if bound is None:
            bound = self.n << (2 * self.wmax)
        c, k = (bound - 1) * a >> self.wmin, 0
        while c > 1:
            c, k = -(-c >> self.wmin), k + 1
        return k


def _bfly_t(T, parts, inverse: bool):
    """_bfly on Fq2Torch (the same root family and units)."""
    r = len(parts)
    if r == 2:
        x0, x1 = parts
        return [T.add(x0, x1), T.sub(x0, x1)]
    if r == 3:
        x0, x1, x2 = parts
        m = T.mul(_w3_pair(T.q, inverse), T.sub(x1, x2))
        return [T.add(x0, T.add(x1, x2)), T.add(T.sub(x0, x2), m),
                T.sub(T.sub(x0, x1), m)]
    x0, x1, x2, x3 = parts
    a, b = T.add(x0, x2), T.sub(x0, x2)
    c, d = T.add(x1, x3), T.sub(x1, x3)
    wd = T.mul_i(d)
    if _w4_is_i(T.q) == inverse:
        wd = T.neg(wd)
    return [T.add(a, c), T.add(b, wd), T.sub(a, c), T.sub(b, wd)]


def _plane_stage(T, x: torch.Tensor, st: StageT, tw: torch.Tensor,
                 inverse: bool) -> torch.Tensor:
    """One stage of plane_fwd (DIF: butterfly, then rows 1..r-1 times tw)
    or plane_inv (DIT: rows 1..r-1 times twi, then butterfly) on a (2, n)
    int64 plane; element (b, t, j) stays at index (b L + t m + j)."""
    v = x.reshape(2, st.B, st.r, st.m)
    tw = tw.to(torch.int64)
    parts = [(v[0, :, k], v[1, :, k]) for k in range(st.r)]
    rows = [(tw[0, k], tw[1, k]) for k in range(st.r)]
    if inverse:
        parts = parts[:1] + [T.mul(rows[k], parts[k])
                             for k in range(1, st.r)]
    outs = _bfly_t(T, parts, inverse)
    if not inverse:
        outs = outs[:1] + [T.mul(rows[k], outs[k]) for k in range(1, st.r)]
    return torch.stack([torch.stack([o[0] for o in outs], 1),
                        torch.stack([o[1] for o in outs], 1)]).reshape(2, -1)


def fwd_stage_plain(t: DevTables3161, i: int, x31: torch.Tensor,
                    x61: torch.Tensor, d: torch.Tensor | None = None):
    """Plain K10: forward stage i of both planes; stage 0 reads the digits
    d (n,) and folds norm(d) x weights first (forward_3161). Returns the
    new (x31 int32, x61 int64) planes."""
    st = t.stages[i]
    if i == 0:
        planes = []
        for T, w in ((T31, t.w31), (T61, t.w61)):
            dq = T.norm(d)
            w = w.to(torch.int64)
            planes.append(torch.stack(T.mul((w[0], w[1]),
                                            (dq, 0 * dq))))
        x31, x61 = planes
    y31 = _plane_stage(T31, x31.to(torch.int64), st, st.tw31, False)
    y61 = _plane_stage(T61, x61, st, st.tw61, False)
    return y31.to(torch.int32), y61


def inv_stage_plain(t: DevTables3161, i: int, x31: torch.Tensor,
                    x61: torch.Tensor):
    """Plain K11: inverse stage i of both planes (new planes); stage 0,
    the last, also folds the unweights, takes the real part and does
    inverse_3161's CRT, and returns the exact 92-bit coefficients as
    (lo, hi) int64 (lo the u64 bit pattern)."""
    st = t.stages[i]
    y31 = _plane_stage(T31, x31.to(torch.int64), st, st.twi31, True)
    y61 = _plane_stage(T61, x61, st, st.twi61, True)
    if i > 0:
        return y31.to(torch.int32), y61
    uw31, uw61 = t.uw31.to(torch.int64), t.uw61
    c31 = T31.mul((uw31[0], uw31[1]), (y31[0], y31[1]))[0]
    c61 = T61.mul((uw61[0], uw61[1]), (y61[0], y61[1]))[0]
    # v = c31 + q31 tmul < 2^92, tmul = (c61 - c31) q31^-1 mod q61, as the
    # reference's (lo, hi): every partial sum below 2^63
    tmul = T61.mulq(T61.subq(c61, c31), field2.Q31_INV_MOD_Q61)
    lo = c31 + (tmul & 0xFFFFFFFF) * M31
    mid = (tmul >> 32) * M31 + (lo >> 32)
    return (lo & 0xFFFFFFFF) | ((mid & 0xFFFFFFFF) << 32), mid >> 32


def pointwise_plain(x31: torch.Tensor, x61: torch.Tensor,
                    m31: torch.Tensor | None = None,
                    m61: torch.Tensor | None = None):
    """Plain K12: each plane squared (Fq2Ops.sqr), or times a
    multiplicand's planes (Fq2Ops.mul); new planes."""
    out = []
    for T, x, m in ((T31, x31, m31), (T61, x61, m61)):
        x = x.to(torch.int64)
        v = (x[0], x[1])
        if m is None:
            y = T.sqr(v)
        else:
            m = m.to(torch.int64)
            y = T.mul(v, (m[0], m[1]))
        out.append(torch.stack(y))
    return out[0].to(torch.int32), out[1]


def carry(t: DevTables3161, lo: torch.Tensor, hi: torch.Tensor, a: int,
          rounds: int) -> torch.Tensor:
    """carry_3161 in torch: digits of (lo + hi 2^64) x a, exact, with
    `rounds` absorb rounds (t.rounds) and the lookahead. a < 2^16."""
    w, masks = t.widths, t.masks
    d = lo & masks
    # v >> w, the shift of lo logical
    c = ((lo >> w) & ~(-1 << (64 - w))) | (hi << (64 - w))
    if a != 1:
        u = d * a
        c = c * a + (u >> w)
        d = u & masks
    return carry_ops.settle(c, d, w, masks, rounds)
