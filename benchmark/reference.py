"""The plain reference: a PRP test's squarings mod M_p = 2^p - 1 and its
Gerbicz-Li accumulator, by the irrational-base discrete weighted transform
(Crandall and Fagin, Math. Comp. 62 (1994) 305-324) on torch's FFT in
float64, and the exact conversions between its digits and Python ints.

It imports neither the port nor JAX and takes nothing the port made: its
transform length, digit layout, weights and bases are worked out here
from p alone. It runs on whatever device it is given (the card in a run,
the CPU in the tests); with dtype=torch.float32 it is the control, the
same arithmetic one precision below.

A value is n balanced digits x_j (float, exact integers) at the bit
positions q_j = ceil(p j / n), with x = sum x_j 2^q_j mod M_p. A square
weights the digits by a_j = 2^(q_j - p j / n), squares by a real FFT,
unweights and rounds (the product's digits, exact while the rounding
error stays under 0.5), then carries twice with balanced remainders: the
first carry brings the ~2^44 coefficients to 2^28 above a digit, the
second to 2^12, which the next square takes. The carry out of the top
digit enters digit 0 (2^p = 1 mod M_p).
"""

from __future__ import annotations

import math

import numpy as np
import torch

BITS_PER_DIGIT_MAX = 17.0   # float64 keeps the rounding error far below 0.5
ERR_EVERY = 16              # products between two samples of the rounding error


def transform_length(p: int) -> int:
    """The shortest n = 2^k, 3 * 2^k or 5 * 2^k with at most
    BITS_PER_DIGIT_MAX bits a digit."""
    need = p / BITS_PER_DIGIT_MAX
    best = None
    for m in (1, 3, 5):
        n = m * 2
        while n < need:
            n *= 2
        best = n if best is None else min(best, n)
    return best


def digit_positions(p: int, n: int) -> np.ndarray:
    """q_j = ceil(p j / n) for j = 0 ... n (q_n = p)."""
    j = np.arange(n + 1, dtype=np.int64)
    return (p * j + n - 1) // n


class Ibdwt:
    """Squarings and products mod M_p on one device."""

    def __init__(self, p: int, device, dtype=torch.float64, n: int = 0):
        self.p = p
        self.n = n or transform_length(p)
        n = self.n
        q = digit_positions(p, n)
        self.widths = np.diff(q)
        num = q[:-1] * n - p * np.arange(n, dtype=np.int64)   # in [0, n)
        w = np.exp2(num / n)
        base = np.exp2(self.widths.astype(np.float64))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        self.w, self.winv = dev(w), dev(1.0 / w)   # irfft divides by n
        self.base, self.ibase = dev(base), dev(1.0 / base)
        self.dtype = dtype
        self.err = torch.zeros((), dtype=dtype, device=device)
        self._count = 0

    def start(self, v: int) -> torch.Tensor:
        assert 0 <= v < 1 << (int(self.widths[0]) - 1)
        x = torch.zeros_like(self.w)
        x[0] = v
        return x

    def square(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.fft.rfft(x * self.w)
        a.mul_(a)
        return self._settle(torch.fft.irfft(a, n=self.n))

    def mul(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        a = torch.fft.rfft(x * self.w)
        a.mul_(torch.fft.rfft(y * self.w))
        return self._settle(torch.fft.irfft(a, n=self.n))

    def _settle(self, c: torch.Tensor) -> torch.Tensor:
        c.mul_(self.winv)
        self._count += 1
        if self._count % ERR_EVERY == 0:
            torch.maximum(self.err, (c - torch.round(c)).abs().max(),
                          out=self.err)
        c.round_()
        for _ in range(2):
            hi = torch.round(c * self.ibase)
            c.addcmul_(hi, self.base, value=-1)
            c[1:].add_(hi[:-1])
            c[:1].add_(hi[-1:])
        return c

    def roundoff(self) -> float:
        """The largest rounding error of the sampled products."""
        return float(self.err)

    def to_int(self, x: torch.Tensor) -> int:
        """The value mod M_p, in [0, M_p)."""
        d = x.to(torch.int64).cpu().numpy()
        pos = pack(np.where(d > 0, d, 0), self.widths)
        neg = pack(np.where(d < 0, -d, 0), self.widths)
        return (pos - neg) % ((1 << self.p) - 1)


def pack(digits: np.ndarray, widths: np.ndarray) -> int:
    """sum digits[j] 2^q_j, q_j = widths[0] + ... + widths[j-1], for
    digits in [0, 2^32): each digit shifted into the 32-bit words it
    touches, the words summed exactly (bincount in float64: sums below
    2^36) and joined."""
    d = np.asarray(digits).astype(np.uint64)
    if d.size and int(d.max()) >> 32:
        raise ValueError("pack takes digits below 2^32")
    q = np.zeros(len(widths), dtype=np.int64)
    np.cumsum(np.asarray(widths, dtype=np.int64)[:-1], out=q[1:])
    word = q >> 5
    v = d << (q & 31).astype(np.uint64)                # below 2^63
    nw = int(word[-1]) + 3 if len(word) else 1
    lo = np.bincount(word, weights=(v & np.uint64(0xFFFFFFFF)).astype(
        np.float64), minlength=nw)
    hi = np.bincount(word + 1, weights=(v >> np.uint64(32)).astype(
        np.float64), minlength=nw)
    acc = (lo + hi).astype(np.uint64)                   # exact: < 2^53
    low = (acc & np.uint64(0xFFFFFFFF)).astype("<u4").tobytes()
    high = (acc >> np.uint64(32)).astype("<u4").tobytes()
    return int.from_bytes(low, "little") + (
        int.from_bytes(high, "little") << 32)


def unpack(v: int, widths: np.ndarray) -> np.ndarray:
    """The digits of v in [0, 2^p) under `widths` (each below 2^57): an
    8-byte window read at each digit's first byte, shifted and masked."""
    w = np.asarray(widths, dtype=np.int64)
    q = np.zeros(len(w), dtype=np.int64)
    np.cumsum(w[:-1], out=q[1:])
    raw = np.frombuffer(v.to_bytes((int(w.sum()) + 7) // 8 + 8, "little"),
                        dtype=np.uint8)
    window = np.zeros(len(w), dtype=np.uint64)
    for k in range(8):
        window |= raw[(q >> 3) + k].astype(np.uint64) << np.uint64(8 * k)
    mask = (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1)
    return (window >> (q & 7).astype(np.uint64)) & mask


def words_off(a: int, b: int, p: int) -> int:
    """How many of the 64-bit words of two values below 2^p differ."""
    x = a ^ b
    if x == 0:
        return 0
    raw = x.to_bytes((p + 63) // 64 * 8, "little")
    return int(np.count_nonzero(np.frombuffer(raw, dtype="<u8")))


def prp_state(p: int, squarings: int, device, dtype=torch.float64,
              n: int = 0) -> tuple[int, int, float]:
    """(R0, R1, rounding error) after `squarings` PRP iterations from 3:
    R0 = 3^(2^squarings), R1 the product of R0 at each Gerbicz-Li block
    boundary passed (iterations i = p mod B, + B, ...; B = isqrt(p);
    1 before the first), all mod M_p."""
    ref = Ibdwt(p, device, dtype=dtype, n=n)
    b = math.isqrt(p)
    boundary = p % b or b
    x = ref.start(3)
    acc = None
    done = 0
    while done < squarings:
        stop = min(boundary, squarings)
        for _ in range(stop - done):
            x = ref.square(x)
        done = stop
        if done == boundary:
            acc = x.clone() if acc is None else ref.mul(acc, x)
            boundary += b
    r1 = 1 if acc is None else ref.to_int(acc)
    return ref.to_int(x), r1, ref.roundoff()
