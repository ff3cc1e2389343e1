"""Host-side conversions between python ints and IBDWT digit vectors.

Mirrors the canonical digit packing of the reference engine export
(reference: include/marin/engine.h:173-232 get_mpz/set_mpz): digit j holds the
width[j] bits of the value starting at bit position q_j = sum(width[:j]).
Vectorized with numpy byte-window gathers so huge exponents stay O(n).
"""

from __future__ import annotations

import numpy as np


def bit_positions(widths: np.ndarray) -> np.ndarray:
    """q_j = starting bit position of digit j (int64)."""
    q = np.zeros(widths.shape[0], dtype=np.int64)
    np.cumsum(widths[:-1].astype(np.int64), out=q[1:])
    return q


def int_to_digits(v: int, widths: np.ndarray) -> np.ndarray:
    """Decompose v (0 <= v < 2^p) into the variable-base digit vector (u64)."""
    p = int(widths.astype(np.int64).sum())
    assert 0 <= v < (1 << p), "value out of range for digit decomposition"
    nbytes = (p + 7) // 8 + 8
    raw = np.frombuffer(v.to_bytes(nbytes, "little"), dtype=np.uint8)
    q = bit_positions(widths)
    byte_off = (q >> 3).astype(np.int64)
    bit_off = (q & 7).astype(np.uint64)
    # gather an 8-byte little-endian window at each digit's byte offset
    window = np.zeros(widths.shape[0], dtype=np.uint64)
    for k in range(8):
        window |= raw[byte_off + k].astype(np.uint64) << np.uint64(8 * k)
    digits = window >> bit_off
    masks = (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
    return digits & masks


def digits_to_int(digits: np.ndarray, widths: np.ndarray) -> int:
    """Reassemble the python int value from a normalized digit vector.

    Supports widths up to ~50 bits (the fft3161 CRT path has ~35-bit
    digits): each digit contributes as two 32-bit halves so no shifted
    term overflows u64."""
    q = bit_positions(widths)
    idx = (q >> 5).astype(np.int64)          # 32-bit word index
    sh = (q & 31).astype(np.uint64)
    M32 = np.uint64(0xFFFFFFFF)
    d = digits.astype(np.uint64)
    c1 = (d & M32) << sh                     # < 2^63
    c2 = (d >> np.uint64(32)) << sh          # contribution at bit q+32
    nwords = int((q[-1] + int(widths[-1])) // 32) + 4
    acc = np.zeros(nwords, dtype=np.uint64)
    np.add.at(acc, idx, c1 & M32)
    np.add.at(acc, idx + 1, (c1 >> np.uint64(32)) + (c2 & M32))
    np.add.at(acc, idx + 2, c2 >> np.uint64(32))
    # acc[i] are exact sums < 2^64; total = sum acc[i] * 2^(32 i)
    lo = (acc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (acc >> np.uint64(32)).astype(np.uint32)
    return int.from_bytes(lo.tobytes(), "little") + (
        int.from_bytes(hi.tobytes(), "little") << 32
    )
