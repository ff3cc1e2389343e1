"""Prime sieves and P-1 exponent construction.

Equivalents of the reference's host number-theory helpers: sieve_base_primes
/ segmented_primes_odd (reference: src/modes/RunPM1.cpp:1278-1340) and
buildE / buildE2 prime-power product with product tree
(reference: include/core/AlgoUtils.hpp:248, :844-888).
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np


def sieve(limit: int) -> np.ndarray:
    """All primes <= limit (int64 array). Fast numpy Eratosthenes."""
    if limit < 2:
        return np.empty(0, dtype=np.int64)
    is_c = np.zeros(limit + 1, dtype=bool)
    is_c[:2] = True
    for q in range(2, int(math.isqrt(limit)) + 1):
        if not is_c[q]:
            is_c[q * q::q] = True
    return np.flatnonzero(~is_c).astype(np.int64)


def segmented_primes(lo: int, hi: int, seg: int = 1 << 22) -> Iterator[np.ndarray]:
    """Yield numpy arrays of primes in [lo, hi) using a segmented sieve."""
    lo = max(lo, 2)
    base = sieve(int(math.isqrt(max(hi - 1, 4))) + 1)
    start = lo
    while start < hi:
        end = min(start + seg, hi)
        size = end - start
        is_c = np.zeros(size, dtype=bool)
        for q in base:
            q = int(q)
            first = max(q * q, ((start + q - 1) // q) * q)
            if first >= end:
                continue
            is_c[first - start::q] = True
        if start <= 1:
            is_c[: 2 - start] = True
        idx = np.flatnonzero(~is_c) + start
        idx = idx[idx >= lo]
        if len(idx):
            yield idx
        start = end


def prime_powers_upto(b1: int, start_prime: int = 2) -> Iterator[int]:
    """Yield p^floor(log_p b1) for each prime start_prime <= p <= b1."""
    for block in segmented_primes(start_prime, b1 + 1):
        for q in block.tolist():
            pw = q
            while pw * q <= b1:
                pw *= q
            yield pw


def product_tree(values: list[int]) -> int:
    """Balanced product of a list of python ints."""
    if not values:
        return 1
    layer = values
    while len(layer) > 1:
        nxt = [layer[i] * layer[i + 1] for i in range(0, len(layer) - 1, 2)]
        if len(layer) & 1:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


def build_e(b1: int, start_prime: int = 2) -> int:
    """E = prod of prime powers <= b1 (reference buildE semantics)."""
    return product_tree(list(prime_powers_upto(b1, start_prime)))


def build_e_chunks(b1: int, max_bits: int, start_prime: int = 2
                   ) -> Iterator[tuple[int, int]]:
    """Yield (E_chunk, next_start_prime) with E_chunk < 2^max_bits.

    Chunked product-tree construction so host memory stays bounded for huge
    B1 (reference buildE2, AlgoUtils.hpp:888); the exponentiation consumes
    chunks left to right: x <- x^(E_chunk).
    """
    buf: list[int] = []
    bits = 0
    last = start_prime
    for block in segmented_primes(start_prime, b1 + 1):
        for q in block.tolist():
            pw = q
            while pw * q <= b1:
                pw *= q
            nb = pw.bit_length()
            if bits + nb > max_bits and buf:
                yield product_tree(buf), q
                buf, bits = [], 0
            buf.append(pw)
            bits += nb
            last = q
    if buf:
        yield product_tree(buf), last + 1


def build_e_delta(b1_old: int, b1_new: int) -> int:
    """Exponent extending a stage-1 result from b1_old to b1_new:
    prod q^(floor(log_q b1_new) - floor(log_q b1_old)) over primes
    q <= b1_new (the reference's B1-extension delta path)."""
    assert b1_new > b1_old
    parts: list[int] = []
    for block in segmented_primes(2, b1_new + 1):
        for q in block.tolist():
            pw_new = q
            while pw_new * q <= b1_new:
                pw_new *= q
            if q > b1_old:
                parts.append(pw_new)
                continue
            pw_old = q
            while pw_old * q <= b1_old:
                pw_old *= q
            if pw_new > pw_old:
                parts.append(pw_new // pw_old)
    return product_tree(parts)
