"""IBDWT transform planning for Mersenne arithmetic mod M_p = 2^p - 1.

Computes the transform size, variable digit widths, and the two-pass (matrix)
NTT decomposition used by the TPU compute path. The Plan is pure metadata;
the big per-element tables (weights, twiddles) are generated vectorized in
the target array namespace by ops/ntt.py (on-device for the JAX engine).

Semantics parity with the reference planner (reference: include/marin/ibdwt.h:17-147):
  * transform size n = 2^k or 5*2^k, n | (P-1)/192, chosen so the convolution
    digits cannot overflow the Goldilocks field: n * (2^(w+1)-1)^2 < P.
  * digit widths: width[j] = ceil(p*(j+1)/n) - ceil(p*j/n)  (values w or w+1)
  * weights: weight[j] = nr2^((n - (p*j mod n)) mod n), nr2^n == 2.

The NTT decomposition is TPU-native and intentionally different from the
reference's radix-kernel dispatch tables: the length-n transform is an (R, C)
matrix four-step NTT (column pass, factored mid-twiddles, transpose, column
pass), which maps onto lane-parallel columns and ICI all-to-all transposes
when sharded.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from . import field


def transform_size(p: int) -> int:
    """Smallest valid Goldilocks IBDWT transform size for exponent p.

    Mirrors the selection rule of the reference (include/marin/ibdwt.h:17-43):
    considers n = 2^k and n = 5*2^k (k <= 26) and picks the smallest n with
    (w+1)*2 + log2(n) < 64 where w = floor(p/n).
    """
    log2_n = 1
    while True:
        log2_n += 1
        w = p >> log2_n
        if (w + 1) * 2 + log2_n < 64:
            break
    log2_n5 = 2
    while True:
        log2_n5 += 1
        w = p // (5 << log2_n5)
        if (w + 1) * 2 + (log2_n5 + 2.4) < 64:
            break
    inf = float("inf")
    n2 = (1 << log2_n) if log2_n <= 26 else inf
    n5 = (5 << log2_n5) if log2_n5 <= 26 else inf
    n = min(n2, n5)
    if n == inf:
        raise ValueError(f"exponent {p} too large for Goldilocks IBDWT")
    return max(int(n), 8)


def digit_widths(p: int, n: int) -> np.ndarray:
    """width[j] = ceil(p*(j+1)/n) - ceil(p*j/n), as uint32.

    Chunked: the one-shot form materializes several (n+1)-element int64
    temporaries — ~6 GB of allocator churn at MM31's n = 167772160,
    measured 40 s of the 59 s plan build; chunks with a preallocated
    output build the same widths in ~2 s."""
    w = np.empty(n, dtype=np.uint32)
    ch = 1 << 22
    prev = np.int64(0)                       # ceil(p*lo/n) at chunk head
    for lo in range(0, n, ch):
        hi = min(lo + ch, n)
        j = np.arange(lo + 1, hi + 1, dtype=np.int64)
        ceils = (p * j + n - 1) // n         # p*j < 2^59, exact in int64
        w[lo] = ceils[0] - prev
        w[lo + 1:hi] = np.diff(ceils).astype(np.uint32)
        prev = ceils[-1]
    assert int(prev) == p                    # == ceil(p*n/n): widths sum
    return w


# ---------------------------------------------------------------------------
# Column-transform stage structure
# ---------------------------------------------------------------------------

def radix_seq(length: int) -> tuple[int, ...]:
    """DIF stage radices for a column transform of `length` = 5^{0,1} * 2^k."""
    seq = []
    L = length
    if L % 5 == 0:
        seq.append(5)
        L //= 5
    k = L.bit_length() - 1
    assert L == 1 << k, f"invalid column length {length}"
    if k % 2 == 1:
        seq.append(2)
        k -= 1
    seq.extend([4] * (k // 2))
    return tuple(seq)


def pos_of_freq(f: int, radixes, length: int) -> int:
    """Physical output index of frequency f after the DIF stage sequence.

    DIF recurrence: pos_L(f) = (f mod r) * (L/r) + pos_{L/r}(f div r).
    """
    pos = 0
    L = length
    for r in radixes:
        m = L // r
        pos += (f % r) * m
        f //= r
        L = m
    return pos


def freq_of_pos(length: int) -> np.ndarray:
    """freq[pos] table for the DIF output ordering of a column transform."""
    radixes = radix_seq(length)
    out = np.empty(length, dtype=np.int64)
    for f in range(length):
        out[pos_of_freq(f, radixes, length)] = f
    return out


def _split_rc(n: int) -> tuple[int, int]:
    """Factor n = R*C. The odd factor 5 goes to R; C is a power of two >= 2.

    R is the first-pass column-transform length (kept modest so a Pallas
    kernel can hold an R x 128 tile in VMEM); C is the lane-parallel width.
    """
    if n % 5 == 0:
        m = n // 5
        k = m.bit_length() - 1
        a = min(k // 2, 11)  # R = 5*2^a <= 10240
        R = 5 << a
    else:
        k = n.bit_length() - 1
        a = min((k + 1) // 2, 12)  # R <= 4096
        R = 1 << a
    C = n // R
    if C < 2:  # tiny transforms
        C = 2
        R = n // 2
    return R, C


@dataclasses.dataclass
class Plan:
    """Transform metadata for exponent p (no big tables)."""
    p: int
    n: int
    R: int
    C: int
    w: int                       # base digit width floor(p/n)
    widths: np.ndarray           # (n,) uint32
    inv_n: int                   # field inverse of n
    radixes_r: tuple[int, ...]
    radixes_c: tuple[int, ...]
    freq_r: np.ndarray           # (R,) DIF output permutation of the R pass

    @property
    def max_word(self) -> int:
        """Upper bound on an unnormalized convolution digit (< P)."""
        return self.n * (2 ** (self.w + 1) - 1) ** 2


def build_plan(p: int, n: int | None = None) -> Plan:
    if n is None:
        n = transform_size(p)
    R, C = _split_rc(n)
    assert R * C == n
    return Plan(
        p=p, n=n, R=R, C=C, w=p // n,
        widths=digit_widths(p, n),
        inv_n=field.inv(n % field.P),
        radixes_r=radix_seq(R),
        radixes_c=radix_seq(C),
        freq_r=freq_of_pos(R),
    )


@lru_cache(maxsize=8)
def cached_plan(p: int, n: int | None = None) -> Plan:
    return build_plan(p, n)
