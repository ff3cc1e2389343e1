"""Residue export: res64 / res2048 formatting and the PRP divide-by-9 rule.

Mirrors the reference conventions (reference: src/modes/RunPrpOrLlMarin.cpp:462-520,
include/core/AlgoUtils.hpp prp3_div9/format_res64_hex): the reported PRP
residue is the Fermat residue 3^(M_p - 1) = final_state / 9 mod M_p, with a
CRT branch when gcd(9, M_p) != 1.
"""

from __future__ import annotations


from ..utils import gmp

def mersenne(p: int) -> int:
    return (1 << p) - 1


def prp_residue(p: int, x: int) -> int:
    """Fermat residue x/9 mod M_p where x = 3^(2^p) mod M_p."""
    mp = mersenne(p)
    if mp % 3 != 0:
        return gmp.mulmod(x, gmp.invert(9, mp), mp)
    # M_p divisible by 3^t: CRT between u = M_p/3^t and 3^t
    # (reference: RunPrpOrLlMarin.cpp:476-515)
    t = 0
    tmp = mp
    while tmp % 3 == 0:
        tmp //= 3
        t += 1
    m3 = 3 ** t
    u = mp // m3
    res_u = gmp.mulmod(x % u, gmp.invert(9, u), u)
    k = (-res_u * gmp.invert(u, m3)) % m3
    return (res_u + k * u) % mp


def res64_hex(v: int) -> str:
    # uppercase, matching the reference result JSON (res2048 is lowercase)
    return f"{v & ((1 << 64) - 1):016X}"


def res2048_hex(v: int) -> str:
    return f"{v & ((1 << 2048) - 1):0512x}"
