"""Carry tables and state between the JAX package and the port.

The JAX pipeline keeps every u64 as a pair of u32 arrays and pads each
carry unit's carry (and, for T > 1 units per row, its spread tables) to a
128-lane block; the port keeps one u64 (in an int64 tensor) per value and
one carry per unit, or per r1 block on the block-carry pipeline (there
both keep (R1, 1)). Everything here works on numpy
arrays (u64 for the port side, u32 pairs for the JAX side) and imports
no jax: a JAX `FourStepTables` is read through np.asarray.

  to_pairs / from_pairs          u64 <-> JAX (lo, hi) u32 pair, e.g. a
                                 spectral multiplicand (mod-P values)
  tables_from_jax                JAX folded n-sized tables -> the port's
  state_to_jax / state_from_jax  register (x, unit carries)
  mesh_state_from_jax /          the JAX mesh state gathered to numpy <->
  mesh_state_to_jax              each rank's r1-sharded (x, carries)

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


def _unpad_units(a, k: int) -> np.ndarray:
    """A JAX spread table (R1, R2, k), or (R1, R2, T*128) padded per unit
    when T > 1 (kernels.py:721-726) -> (R1, R2, T, k)."""
    a = np.asarray(a).astype(np.uint32)
    if a.shape[-1] == k:
        return a[:, :, None, :]
    return a.reshape(a.shape[:2] + (-1, 128))[..., :k]


def tables_from_jax(jt, k: int) -> dict:
    """A JAX FourStepTables with its fused-C, wcorr and cinrow tables
    attached, and the plan's spread-part count k -> the port's n-sized
    tables: mf, mi (R1, R2, C) u64, er (R1, R2) and ec (C,) u32, wt and cum
    (R1, R2, T, k) u32, widths (R1, R2, C) u32 (names as in
    ops/fourstep.KernelTables)."""
    (*_mats, mf0, mf1, mi0, mi1) = jt.fused
    widths = np.asarray(jt.widths32).astype(np.uint32)
    R1, R2, C = widths.shape
    return {
        "mf": from_pairs(mf0, mf1).reshape(R1, R2, C),
        "mi": from_pairs(mi0, mi1).reshape(R1, R2, C),
        "er": np.asarray(jt.wcorr[0]).astype(np.uint32).reshape(R1, R2),
        "ec": np.asarray(jt.wcorr[1]).astype(np.uint32).reshape(C),
        "wt": _unpad_units(jt.cinrow[0], k),
        "cum": _unpad_units(jt.cinrow[1], k),
        "widths": widths,
    }


def state_to_jax(x, co):
    """Port register x (R1, R2, C) u64 and carries co -> JAX ((x0, x1),
    (c0, c1)): unit carries (R1, R2, T) become the carry block (R1, R2,
    T*128) with unit t's value in lane t*128; block carries (R1, 1) cross
    as they are."""
    co = np.asarray(co, dtype=np.uint64)
    if co.ndim == 2:
        return to_pairs(x), to_pairs(co)
    block = np.zeros(co.shape + (128,), dtype=np.uint64)
    block[..., 0] = co
    return to_pairs(x), to_pairs(block.reshape(co.shape[:2] + (-1,)))


def state_from_jax(x0, x1, c0, c1):
    """JAX register pairs and carries, the (R1, R2, T*128) row-carry block
    or the (R1, 1) block carries -> (x (R1, R2, C) u64, co (R1, R2, T) or
    (R1, 1) u64)."""
    c0, c1 = np.asarray(c0), np.asarray(c1)
    if c0.ndim == 2 and c0.shape[-1] == 1:
        return from_pairs(x0, x1), from_pairs(c0, c1)
    if c0.ndim != 3 or c0.shape[-1] % 128:
        raise ValueError("the carries must be (R1, R2, T*128) or (R1, 1)")
    return from_pairs(x0, x1), from_pairs(c0[..., ::128], c1[..., ::128])


def mesh_state_from_jax(x0, x1, c0, c1, s: int) -> list:
    """The JAX mesh state gathered to numpy (register pairs (R1, R2, C);
    the (R1, R2, T*128) row-carry block or the (R1, 1) block carries) ->
    [(x (R1/s, R2, C), co (R1/s, R2, T) or (R1/s, 1)) u64 for each rank],
    the rank's rows of each (r1-sharded, as the JAX mesh keeps them)."""
    x, co = state_from_jax(x0, x1, c0, c1)
    return list(zip(np.split(x, s), np.split(co, s)))


def mesh_state_to_jax(states):
    """The ranks' (x, co), in rank order -> the JAX mesh state gathered:
    ((x0, x1), (c0, c1))."""
    return state_to_jax(np.concatenate([x for x, _ in states]),
                        np.concatenate([co for _, co in states]))
