"""Instant answers for tiny exponents (reference: src/core/QuickChecker.cpp:30-44)."""

from __future__ import annotations

KNOWN_SMALL_MERSENNE_PRIMES = {2, 3, 5, 7, 13, 17, 19, 31, 61, 89, 107, 127}

MAX_EXPONENT = 5650242869  # reference CLI bound (unit_tests.sh:91-107)


def quick_check(p: int) -> bool | None:
    """True/False if instantly known (p < 127), None if a real test is needed."""
    if p < 127:
        return p in KNOWN_SMALL_MERSENNE_PRIMES
    return None


def validate_exponent(p: int) -> None:
    if p < 2:
        raise ValueError(f"exponent {p} too small")
    if p > MAX_EXPONENT:
        raise ValueError(
            f"exponent {p} exceeds the maximum supported exponent {MAX_EXPONENT}")
