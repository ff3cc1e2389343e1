"""Goldilocks GF(P) arithmetic in plain torch, P = 2^64 - 2^32 + 1.

Counterpart of prmers_tpu/ops/pallas/gl64.py. The CUDA kernels use
csrc/gl64.cuh (native u64, __umul64hi, the Solinas fold 2^64 = 2^32 - 1);
this module is the plain version the CPU runs and the kernels are held
against.

torch has no usable unsigned 64-bit arithmetic on the CPU (uint32/uint64
add, sub, shift and compare raise), so a value is a pair (lo, hi) of int64
tensors, each word in [0, 2^32). Values are lazy: any v = lo + hi*2^32 <
2^64 in the right residue class; `canon` reduces to [0, P).

Registers and kernel buffers hold the same 64-bit pattern in ONE int64
tensor (`join`); `split` recovers the pair. torch's int64 `<<` wraps like
u64 and `>>` sign-extends, so the masks in `split` make both exact.

Products use 16-bit limbs: a limb product is < 2^32 and a sum of the few
products that share a position stays far below 2^63; `_fold7` turns the
seven limb-position sums back into a lazy pair with 2^64 = 2^32 - 1 and
2^96 = -1. Matrix products (`matmul_mod`) take the same limbs through
float64 matmuls, exact while each dot stays below 2^53 (512 terms of
2^32 is 2^41).

`TorchField` (at the end) is the field of the any-size engine's
transform: the same 16-bit limbs, held as float64 and carried lazily.
"""

from __future__ import annotations

import torch

P = (1 << 64) - (1 << 32) + 1
M32 = 0xFFFFFFFF
M16 = 0xFFFF


# -- packing -----------------------------------------------------------------

def split(x: torch.Tensor):
    """int64 tensor holding u64 bit patterns -> (lo, hi) words."""
    return x & M32, (x >> 32) & M32


def join(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) words -> int64 tensor holding the u64 bit pattern."""
    return lo | (hi << 32)


def norm(lo: torch.Tensor, hi: torch.Tensor):
    """Signed word sums (|lo|, |hi| < 2^61) of v = lo + hi*2^32 -> a lazy
    pair with both words in [0, 2^32). Each round moves the low word's
    overflow up and folds the high word's overflow h*2^64 back as
    h*(2^32 - 1); three rounds settle every input in range."""
    for _ in range(3):
        c = lo >> 32
        lo = lo & M32
        hi = hi + c
        h2 = hi >> 32
        hi = (hi & M32) + h2
        lo = lo - h2
    return lo, hi


def _fold7(T):
    """Seven limb-position sums T[k] (value sum_k T[k] * 2^(16k), each
    T[k] < 2^43) -> lazy pair mod P."""
    w0 = T[0] + (T[1] << 16)
    w1 = T[2] + (T[3] << 16)
    w2 = T[4] + (T[5] << 16)
    w3 = T[6]
    # w0 + w1*2^32 + w2*2^64 + w3*2^96 = (w0 - w2 - w3) + (w1 + w2)*2^32
    return norm(w0 - w2 - w3, w1 + w2)


def _limbs(lo, hi):
    return [lo & M16, lo >> 16, hi & M16, hi >> 16]


# -- modular ops (lazy in, lazy out) ----------------------------------------

def add(a0, a1, b0, b1):
    return norm(a0 + b0, a1 + b1)


def sub(a0, a1, b0, b1):
    return norm(a0 - b0, a1 - b1)


def mul(a0, a1, b0, b1):
    A = _limbs(a0, a1)
    B = _limbs(b0, b1)
    T = [None] * 7
    for i in range(4):
        for j in range(4):
            t = A[i] * B[j]
            T[i + j] = t if T[i + j] is None else T[i + j] + t
    return _fold7(T)


def sqr(a0, a1):
    return mul(a0, a1, a0, a1)


def mul_small(a0, a1, s):
    """Multiply by a small constant or tensor s < 2^32."""
    if not isinstance(s, torch.Tensor):
        s = torch.tensor(int(s), dtype=torch.int64, device=a0.device)
    return mul(a0, a1, s & M32, torch.zeros_like(s))


def const(v: int, like: torch.Tensor):
    """A python int (mod P) as a broadcastable pair on like's device."""
    v %= P
    return (torch.tensor(v & M32, dtype=torch.int64, device=like.device),
            torch.tensor(v >> 32, dtype=torch.int64, device=like.device))


def shiftmul(a0, a1, e: int):
    """a * 2^e mod P for a static e in [0, 96) (2^96 = -1)."""
    assert 0 <= e < 96
    c0, c1 = const(pow(2, e, P), a0)
    return mul(a0, a1, c0, c1)


def halve_where(a0, a1, mask):
    """a/2 mod P where mask: (a >> 1) + lsb * (P + 1)/2, no wrap."""
    lsb = a0 & 1
    h0 = (a0 >> 1) | ((a1 & 1) << 31)
    h1 = a1 >> 1
    r0, r1 = norm(h0 + lsb * 0x80000001, h1 + lsb * 0x7FFFFFFF)
    return torch.where(mask, r0, a0), torch.where(mask, r1, a1)


def double_where(a0, a1, mask):
    """2a mod P where mask (the 2^64 overflow folds as 2^32 - 1)."""
    r0, r1 = norm(a0 << 1, a1 << 1)
    return torch.where(mask, r0, a0), torch.where(mask, r1, a1)


def canon(a0, a1):
    """Lazy pair -> canonical [0, P): a < 2^64 < 2P needs at most one
    subtract, and a >= P exactly when hi = 2^32 - 1 and lo >= 1."""
    ge = (a1 == M32) & (a0 >= 1)
    return torch.where(ge, a0 - 1, a0), torch.where(ge, 0, a1)


# -- packed (u64-in-int64) helpers for the kernels' plain versions -----------

def mulmod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return join(*mul(*split(x), *split(y)))


def canon64(x: torch.Tensor) -> torch.Tensor:
    return join(*canon(*split(x)))


def matmul_mod(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(A @ B) mod P for packed u64 operands A (..., K, J) and B (..., J, N)
    with J <= 512 (the radix-5 r2 DFT has J = 320): sixteen float64 limb
    matmuls, exact below 2^53, and each position sum of four of them below
    the 2^43 that _fold7 takes."""
    assert A.shape[-1] <= 512
    Al = [((A >> (16 * i)) & M16).to(torch.float64) for i in range(4)]
    Bl = [((B >> (16 * i)) & M16).to(torch.float64) for i in range(4)]
    T = [None] * 7
    for i in range(4):
        for j in range(4):
            t = torch.matmul(Al[i], Bl[j])
            T[i + j] = t if T[i + j] is None else T[i + j] + t
    return join(*_fold7([t.to(torch.int64) for t in T]))


def from_numpy_u64(a, device) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bit pattern."""
    import numpy as np
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_numpy_u64(x: torch.Tensor):
    """int64 tensor of u64 bit patterns -> numpy uint64 array."""
    import numpy as np
    return x.detach().cpu().contiguous().numpy().view(np.uint64).copy()


# -- the any-size engine's field: 16-bit limbs in float64 --------------------
#
# ops/ntt.py's forward and inverse call add, sub, mul and mul_scalar some
# forty times per radix-4 stage on small tensors, so on the card a squaring
# costs what its torch launches cost. On packed words each of those ops is
# dozens of launches (the split, sixteen limb products, the norm rounds);
# here a value is four limbs v = sum_k D[k] 2^(16k) held as float64 in one
# (4, ...) tensor, each limb any integer of magnitude up to a tracked bound:
# add and sub are one launch with no carry, and a product is one broadcast
# product of the limbs, one float64 matmul that folds the sixteen limb
# products into four limbs mod P (2^64 = 2^32 - 1, 2^80 = 2^48 - 2^16,
# 2^96 = -1), and carry rounds of two launches each. Every value stays an
# integer below 2^53, where float64 is exact on any device and in any
# summation order: the bound of each result is known on the host, and an
# operand is carried before a product or a sum that could pass 2^52 (the
# headroom keeps a carry round's partial sums below 2^53).

_EXACT = 1 << 52
_LIMB = 1 << 16
_MUL_OUT = 1 << 24          # a product's limbs are carried down to this
_LOWER = 1 << 20            # and lower's, before the words are formed
_ROUND_MIN = 3 * M16 + 2    # the least bound a carry round leaves
# limb j of the product from limb products at 2^(16 m), m = i + k
_FOLD_TO = {0: {0: 1}, 1: {1: 1}, 2: {2: 1}, 3: {3: 1},
            4: {2: 1, 0: -1}, 5: {3: 1, 1: -1}, 6: {0: -1}}
_FOLD_TERMS = 6             # the most limb products one output limb sums
# a carry round moves two limbs' worth at once: with c1 = floor(D / 2^16)
# and c2 = floor(D / 2^32) (one broadcast division), D = r0 + 2^16 r1 +
# 2^32 c2 limb by limb with r0 = D - 2^16 c1 and r1 = c1 - 2^16 c2 in
# [0, 2^16); 2^16 x at limb k is x at limb k + 1 (C1: the top limb's,
# 2^64 = 2^32 - 1, to limbs 2 (+) and 0 (-)) and 2^32 x two limbs up
# (C2 = C1 C1), so one matmul adds (C1 - 2^16 I) c1 + (C2 - 2^16 C1) c2
# to D, and every limb is then below 3 (2^16 - 1) + 2 (B / 2^32 + 1)
_CARRY_TO = [[0, 0, 0, -1], [1, 0, 0, 0], [0, 1, 0, 1], [0, 0, 1, 0]]


class Limbs:
    """A tensor of field values as (4, *shape) float64 limbs with a bound on
    every limb's magnitude. It takes the reshapes, indexing and .T that
    ops/ntt.py applies to its arrays, and the swapaxes of the batched
    engine's lane forms (engine/batch.py), on the logical shape."""

    def __init__(self, d: torch.Tensor, bound: int):
        self.d = d
        self.bound = bound

    @property
    def shape(self):
        return tuple(self.d.shape[1:])

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Limbs(self.d.reshape((4,) + tuple(shape)), self.bound)

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        return Limbs(self.d[(slice(None),) + idx], self.bound)

    @property
    def T(self):
        assert self.d.dim() == 3, "Limbs.T is the transpose of a matrix"
        return Limbs(self.d.transpose(1, 2), self.bound)

    def swapaxes(self, a: int, b: int):
        nd = self.d.dim() - 1
        return Limbs(self.d.transpose(a % nd + 1, b % nd + 1), self.bound)


class _LimbNamespace:
    """The array functions ops/ntt.py's transforms call through F.xp."""

    @staticmethod
    def stack(arrays, axis=0):
        return Limbs(torch.stack([a.d for a in arrays], dim=axis + 1),
                     max(a.bound for a in arrays))


def _left_pad(d: torch.Tensor, ndim: int) -> torch.Tensor:
    """Limbs d (4, *s) viewed as (4, 1, ..., 1, *s) with ndim logical dims,
    so that two operands broadcast as their logical shapes do."""
    extra = ndim - (d.dim() - 1)
    return d.reshape((4,) + (1,) * extra + tuple(d.shape[1:])) if extra \
        else d


class TorchField:
    """The field ops ops/ntt.py asks of F (add, sub, mul, sqr, mul_scalar,
    pow_const and xp.stack) on Limbs, for one device; `lift` and `lower`
    convert from and to the port's registers (int64 tensors of u64 bit
    patterns), `lower` to canonical values in [0, P)."""

    xp = _LimbNamespace

    def __init__(self, device):
        self.device = torch.device(device)
        fold = [[0.0] * 16 for _ in range(4)]
        for i in range(4):
            for k in range(4):
                for j, c in _FOLD_TO[i + k].items():
                    fold[j][4 * i + k] += c
        f64 = dict(dtype=torch.float64, device=self.device)
        self._fold = torch.tensor(fold, **f64)
        c1 = torch.tensor(_CARRY_TO, **f64)
        self._round = torch.cat([c1 - _LIMB * torch.eye(4, **f64),
                                 c1 @ c1 - _LIMB * c1], dim=1)
        self._scales = torch.tensor([_LIMB, _LIMB * _LIMB],
                                    **f64).reshape(2, 1, 1)
        self._shifts = torch.tensor([0, 16, 32, 48], dtype=torch.int64,
                                    device=self.device)
        self._consts: dict[int, Limbs] = {}

    # -- conversions ----------------------------------------------------------
    def lift(self, x: torch.Tensor) -> Limbs:
        """int64 u64 patterns -> Limbs with limbs in [0, 2^16)."""
        sh = self._shifts.reshape((4,) + (1,) * x.dim())
        return Limbs(((x.unsqueeze(0) >> sh) & M16).to(torch.float64),
                     M16)

    def lower(self, a: Limbs) -> torch.Tensor:
        """Limbs -> int64 tensor of the canonical values in [0, P)."""
        a = self.carried(a, _LOWER)
        q = a.d.to(torch.int64)
        lo, hi = norm(q[0] + (q[1] << 16), q[2] + (q[3] << 16))
        return join(*canon(lo, hi))

    def const(self, c: int) -> Limbs:
        """A python int mod P as broadcastable Limbs (cached per value: a
        graph capture may not copy from the host)."""
        c %= P
        if c not in self._consts:
            d = torch.tensor([(c >> s) & M16 for s in (0, 16, 32, 48)],
                             dtype=torch.float64, device=self.device)
            self._consts[c] = Limbs(d, M16)
        return self._consts[c]

    # -- carries --------------------------------------------------------------
    def carry_round(self, a: Limbs) -> Limbs:
        shape = a.d.shape
        d = a.d.reshape(4, -1)
        c = torch.div(d.unsqueeze(0), self._scales, rounding_mode="floor")
        out = torch.addmm(d, self._round, c.reshape(8, -1))
        return Limbs(out.reshape(shape),
                     _ROUND_MIN + 2 * (a.bound >> 32))

    def carried(self, a: Limbs, limit: int) -> Limbs:
        """a with carry rounds until every limb's bound is at most limit
        (limit >= 2^18: a round cannot take the bound below _ROUND_MIN)."""
        assert limit >= 4 * _LIMB
        while a.bound > limit:
            a = self.carry_round(a)
        return a

    # -- the ops ntt.py calls -------------------------------------------------
    def add(self, a: Limbs, b: Limbs) -> Limbs:
        a, b = self._fit_sum(a, b)
        nd = max(len(a.shape), len(b.shape))
        return Limbs(_left_pad(a.d, nd) + _left_pad(b.d, nd),
                     a.bound + b.bound)

    def sub(self, a: Limbs, b: Limbs) -> Limbs:
        a, b = self._fit_sum(a, b)
        nd = max(len(a.shape), len(b.shape))
        return Limbs(_left_pad(a.d, nd) - _left_pad(b.d, nd),
                     a.bound + b.bound)

    def mul(self, a: Limbs, b: Limbs) -> Limbs:
        while _FOLD_TERMS * a.bound * b.bound >= _EXACT:
            if a.bound >= b.bound:
                a = self.carry_round(a)
            else:
                b = self.carry_round(b)
        nd = max(len(a.shape), len(b.shape))
        prod = _left_pad(a.d, nd).unsqueeze(1) * \
            _left_pad(b.d, nd).unsqueeze(0)
        shape = prod.shape[2:]
        out = torch.mm(self._fold, prod.reshape(16, -1))
        return self.carried(Limbs(out.reshape((4,) + tuple(shape)),
                                  _FOLD_TERMS * a.bound * b.bound), _MUL_OUT)

    def sqr(self, a: Limbs) -> Limbs:
        return self.mul(a, a)

    def mul_scalar(self, a: Limbs, c: int) -> Limbs:
        return self.mul(a, self.const(c))

    def pow_const(self, a: Limbs, e: int) -> Limbs:
        r = None
        while e > 0:
            if e & 1:
                r = a if r is None else self.mul(r, a)
            e >>= 1
            if e:
                a = self.sqr(a)
        if r is None:
            return self.add(self.sub(a, a), self.const(1))
        return r

    def _fit_sum(self, a: Limbs, b: Limbs):
        while a.bound + b.bound >= _EXACT:
            if a.bound >= b.bound:
                a = self.carry_round(a)
            else:
                b = self.carry_round(b)
        return a, b
