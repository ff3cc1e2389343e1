"""The int8 limb-plane tables of a Goldilocks matrix: K4u/K5u's matrix form
on the card's int8 tensor cores.

Port: a copy of the host-side table builders of prmers_tpu/ops/pallas/
mxu_dft.py (the "scaled-matrix" formulation, mxu_dft.py:1-35): an (L, L)
matrix M mod P becomes the (8L, 8L) int8 table W8 of the balanced byte
limbs of M * 256^l, and one int8 product W8 @ X, X the eight bytes of each
input word XOR 0x80, gives eight diagonal planes whose sum over 2^(8m) is
M @ x mod P once `corr` is added (the x-side 128 offset, the per-plane
offset that keeps the planes non-negative, and that offset's mod-P
complement). Copied: _plane_offset, N_WPLANES, _MAXPOS8, _balanced_limbs,
_balanced_limbs_vec, _fold_sub_into_corr. Changed:
  _mulmod_u64       the port's numpy product (fourstep.mulmod) in place of
                    the reference's u32-pair GL(np);
  build_mxu_tables  builds the scaled matrices as the original does, then
                    hands them to tables_from_mats.
Added:
  tables_from_mats  the original's tail: (K, L, L) u64 matrices, the
                    port's own (fourstep.UnfoldedTables' tr_fwd, d1i, g2,
                    tri), to (W8, corr);
  device_layout     (W8, corr) permuted and padded for csrc/s8_dft.cuh.
The rest of mxu_dft.py (the in-kernel apply, the TPU's bitcast orders)
stays in the reference: tests/test_torch_s8dft.py runs it under numpy.

The device layout (device_layout): Mp = Kp = 128 * ceil(L / 16).
  columns byte-minor  c * 8 + l: input word c's eight bytes are contiguous
                      in the contraction, so the kernel's B tile is the
                      words themselves (one XOR 0x80.. and one store each);
                      columns c >= L are zero;
  rows                (r >> 3) * 64 + m * 8 + (r & 7) for output r, plane
                      m: a 64-row tile holds eight whole outputs, and the
                      mma accumulator gives lane g (= lane / 4) rows g and
                      g + 8 of each 16-row tile, so one lane holds all
                      eight planes of output 8T + g and combines them in
                      registers; rows of outputs r >= L are zero.
corr follows the rows (zero in padding rows).
"""

from __future__ import annotations

import numpy as np

from .fourstep import P, dft_matrix, mulmod


def _plane_offset(contraction: int) -> int:
    """Per-plane offset making D + corr provably non-negative: the dot
    accumulates `contraction` products W*u with |W| <= 128, u <= 255, so
    sum W*u >= -contraction*128*255; the offset is the next power of two.
    (The round-1 fixed 2^23 covered the typical but not the worst case.)"""
    bound = contraction * 128 * 255
    return 1 << (bound - 1).bit_length()


N_WPLANES = 8

# Largest value an 8-digit balanced base-256 decomposition can reach:
# 127 * (256^8 - 1) / 255. P - MAXPOS8 <= -(minimum) holds, so every
# residue mod P is representable as v (v <= MAXPOS8) or v - P.
_MAXPOS8 = 127 * ((1 << 64) - 1) // 255


def _balanced_limbs(v: int) -> list[int]:
    """Exact signed 8-limb base-256 decomposition of the representative
    v or v - P (d in [-128, 127]); v - P is encoded by decomposing
    v + 2^32 - 1 (< 2^64) and dropping the +2^64 leftover."""
    digits = []
    x = v if v <= _MAXPOS8 else v + (1 << 32) - 1
    wrap = v > _MAXPOS8
    for _ in range(N_WPLANES):
        d = x & 255
        x >>= 8
        if d >= 128:
            d -= 256
            x += 1
        digits.append(d)
    assert x == (1 if wrap else 0), f"value {v} out of 8-limb range"
    return digits


def _balanced_limbs_vec(v: np.ndarray) -> np.ndarray:
    """Vectorized _balanced_limbs: u64 array -> int8 array (8, *v.shape).
    Entries above _MAXPOS8 are recoded as v - P: v + (2^32 - 1) never
    overflows u64 for v < P, and the leftover +2^64 is dropped."""
    wrap = v > np.uint64(_MAXPOS8)
    x = v + wrap.astype(np.uint64) * np.uint64((1 << 32) - 1)
    out = np.empty((N_WPLANES,) + v.shape, dtype=np.int8)
    for m in range(N_WPLANES):
        d = (x & np.uint64(255)).astype(np.int64)
        x = x >> np.uint64(8)
        neg = d >= 128
        d = np.where(neg, d - 256, d)
        x = x + neg.astype(np.uint64)
        out[m] = d.astype(np.int8)
    assert (x == wrap.astype(np.uint64)).all(), "value out of 8-limb range"
    return out


def _mulmod_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return mulmod(a, b)


def _fold_sub_into_corr(corr: np.ndarray, off: int, plane_axis_stride: int,
                        plane_axis: int):
    """Fold the static plane-offset compensation into corr: adding the
    byte-planes of (P - sum_m off*2^(8m)) mod P makes the assembled value
    ≡ true + P ≡ true (mod P) directly, so the combine needs NO final
    subtract (saves a sub64 + fold_borrow per element per dot)."""
    sub = sum((off << (8 * m)) for m in range(N_WPLANES)) % P
    sbar = (P - sub) % P
    L = plane_axis_stride
    for m in range(N_WPLANES):
        b = (sbar >> (8 * m)) & 0xFF
        if not b:
            continue
        sl = [slice(None)] * corr.ndim
        sl[plane_axis] = slice(m * L, (m + 1) * L)
        corr[tuple(sl)] += np.int32(b)
    return corr


def build_mxu_tables(L: int, inverse: bool, row_scale: np.ndarray = None,
                     col_scale: np.ndarray = None):
    """Returns (W8 int8, corr int32).

    W8[m*L + r, l*L + c] = balanced limb m of (M[r, c] * 256^l mod P).
    corr adds back the x-side 128 offset, the per-plane offset, and the
    byte-planes of the offset's mod-P complement — the combine is then
    subtraction-free.

    row_scale: optional (K, L) u64 — per-variant OUTPUT-row scalings (the
    inter-factor twiddles / inverse weights, constant across a kernel
    invocation's lanes): variant k encodes diag(row_scale[k]) @ M.
    col_scale: optional (K, L) u64 — per-variant INPUT-column scalings
    (the forward IBDWT weight r-parts): ... @ M @ diag(col_scale[k]).
    With either, W8 is (K, 8L, 8L) and corr (K, 8L, 1); otherwise 2D.
    """
    M = dft_matrix(L, inverse)           # (L, L) u64
    if row_scale is None and col_scale is None:
        Mk = M[None]                     # K = 1
    else:
        Mk = M[None]
        if row_scale is not None:
            Mk = _mulmod_u64(row_scale[:, :, None], Mk)    # (K, L, L)
        if col_scale is not None:
            Mk = _mulmod_u64(Mk, col_scale[:, None, :])
    W8, corr = tables_from_mats(Mk)
    if row_scale is None and col_scale is None:
        W8, corr = W8[0], corr[0]
    return W8, corr


def tables_from_mats(Mk: np.ndarray):
    """(K, L, L) u64 matrices -> (W8 (K, 8L, 8L) int8, corr (K, 8L, 1)
    int32) in build_mxu_tables' order (its body from the scaled matrices
    on)."""
    K, L = Mk.shape[0], Mk.shape[1]
    scales = np.array([pow(256, l, P) for l in range(8)], dtype=np.uint64)
    # (K, L, 8, L): entry [k, r, l, c] = M_k[r, c] * 256^l mod P
    Ml = _mulmod_u64(Mk[:, :, None, :], scales[None, None, :, None])
    limbs = _balanced_limbs_vec(Ml)      # (8, K, L, 8, L) int8
    W8 = np.ascontiguousarray(
        limbs.transpose(1, 0, 2, 3, 4).reshape(K, N_WPLANES * L, 8 * L))
    # x-side 128-offset compensation, with the plane offset baked in
    # (saves one add per plane in the combine)
    off = _plane_offset(8 * L)
    corr = (W8.astype(np.int64).sum(axis=2) * 128 + off
            ).astype(np.int32)
    corr = corr.reshape(K, N_WPLANES * L, 1)
    corr = _fold_sub_into_corr(corr, off, L, 1)
    return W8, corr


def padded(L: int) -> int:
    """Mp = Kp: the device table's rows and contraction, 128 * ceil(L/16)
    (eight outputs per 64-row tile, two tiles a ring stage; the
    contraction a multiple of the kernel's 128-byte ring stage, so of
    mma's 32)."""
    return 128 * -(-L // 16)


def device_layout(W8: np.ndarray, corr: np.ndarray):
    """(W8 (K, 8L, 8L), corr (K, 8L, 1)) in build_mxu_tables' order ->
    (Wd (K, Mp, Kp) int8, cd (K, Mp) int32) in the device order of the
    module's docstring, zero-padded."""
    K, L = W8.shape[0], W8.shape[1] // N_WPLANES
    Rp = padded(L) // 8                  # outputs and words, padded
    w = W8.reshape(K, N_WPLANES, L, 8, L).transpose(0, 2, 1, 4, 3)
    wp = np.zeros((K, Rp, N_WPLANES, Rp, 8), dtype=np.int8)
    wp[:, :L, :, :L, :] = w              # [k, r, m, c, l]
    wp = wp.reshape(K, Rp // 8, 8, N_WPLANES, Rp * 8)
    Wd = np.ascontiguousarray(wp.transpose(0, 1, 3, 2, 4).reshape(
        K, Rp * 8, Rp * 8))
    c = corr.reshape(K, N_WPLANES, L).transpose(0, 2, 1)
    cp = np.zeros((K, Rp, N_WPLANES), dtype=np.int32)
    cp[:, :L, :] = c
    cd = np.ascontiguousarray(cp.reshape(K, Rp // 8, 8, N_WPLANES)
                              .transpose(0, 1, 3, 2).reshape(K, Rp * 8))
    return Wd, cd
