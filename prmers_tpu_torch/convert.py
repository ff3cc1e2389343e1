"""Carry tables and state between the JAX package and the port.

The JAX pipeline keeps every u64 as a pair of u32 arrays and pads its
per-row carries to a 128-lane block; the port keeps one u64 (in an int64
tensor) per value and one carry per row. Everything here works on numpy
arrays (u64 for the port side, u32 pairs for the JAX side) and imports
no jax: a JAX `FourStepTables` is read through np.asarray.

  to_pairs / from_pairs          u64 <-> JAX (lo, hi) u32 pair, e.g. a
                                 spectral multiplicand (mod-P values)
  tables_from_jax                JAX folded n-sized tables -> the port's
  state_to_jax / state_from_jax  register (x, row carries)

Register and carry values cross unchanged (the carries in both are the
unrolled out-carries of the last K3); multiplicands agree mod P.
"""

from __future__ import annotations

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def to_pairs(a64) -> tuple[np.ndarray, np.ndarray]:
    a64 = np.asarray(a64, dtype=np.uint64)
    return (a64 & _M32).astype(np.uint32), (a64 >> _S32).astype(np.uint32)


def from_pairs(lo, hi) -> np.ndarray:
    return (np.asarray(lo).astype(np.uint64) |
            (np.asarray(hi).astype(np.uint64) << _S32))


def tables_from_jax(jt) -> dict:
    """A JAX FourStepTables with its fused-C, wcorr and cinrow tables
    attached (T == 1) -> the port's n-sized tables: mf, mi (R1, R2, C) u64,
    er (R1, R2) and ec (C,) u32, wt and cum (R1, R2, k) u32, widths
    (R1, R2, C) u32 (names as in ops/fourstep.KernelTables)."""
    (*_mats, mf0, mf1, mi0, mi1) = jt.fused
    widths = np.asarray(jt.widths32).astype(np.uint32)
    R1, R2, C = widths.shape
    return {
        "mf": from_pairs(mf0, mf1).reshape(R1, R2, C),
        "mi": from_pairs(mi0, mi1).reshape(R1, R2, C),
        "er": np.asarray(jt.wcorr[0]).astype(np.uint32).reshape(R1, R2),
        "ec": np.asarray(jt.wcorr[1]).astype(np.uint32).reshape(C),
        "wt": np.asarray(jt.cinrow[0]).astype(np.uint32),
        "cum": np.asarray(jt.cinrow[1]).astype(np.uint32),
        "widths": widths,
    }


def state_to_jax(x, co):
    """Port register x (R1, R2, C) u64 and row carries co (R1, R2) u64 ->
    JAX ((x0, x1), (c0, c1)) with the carry block (R1, R2, 128), the value
    in lane 0."""
    co = np.asarray(co, dtype=np.uint64)
    block = np.zeros(co.shape + (128,), dtype=np.uint64)
    block[..., 0] = co
    return to_pairs(x), to_pairs(block)


def state_from_jax(x0, x1, c0, c1):
    """JAX register pairs and (R1, R2, T*128) carry block (T == 1) ->
    (x (R1, R2, C) u64, co (R1, R2) u64)."""
    c0 = np.asarray(c0)
    if c0.shape[-1] != 128:
        raise ValueError("only whole-row carries (carry_tiles == 1) cross")
    return from_pairs(x0, x1), from_pairs(c0[..., 0], np.asarray(c1)[..., 0])
