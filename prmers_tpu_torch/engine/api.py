"""Abstract residue-register engine API.

Every number-theory mode (PRP, LL, P-1, ECM, ...) is written against this
interface, mirroring the reference contract (reference: include/marin/engine.h:36-146)
so each algorithm ports once and runs on any backend (numpy oracle, JAX
single-chip, JAX sharded mesh).

A register holds one residue mod M_p = 2^p - 1 as an IBDWT digit vector of
length n (the transform size); `set_multiplicand` stores the forward transform
(spectral form) instead, which is the only legal `src` of `mul`.
"""

from __future__ import annotations

import abc
from typing import Sequence

import numpy as np

from ..utils import digits as dg

Reg = int


class Engine(abc.ABC):
    """Residue arithmetic engine over registers."""

    def __init__(self, p: int, reg_count: int):
        self.p = p
        self.reg_count = reg_count

    # -- core ops (reference: include/marin/engine.h:36-146) ---------------
    @abc.abstractmethod
    def get_size(self) -> int: ...

    @property
    def widths(self) -> np.ndarray: ...

    @abc.abstractmethod
    def set(self, dst: Reg, a: int) -> None: ...

    @abc.abstractmethod
    def copy(self, dst: Reg, src: Reg) -> None: ...

    @abc.abstractmethod
    def square_mul(self, src: Reg, a: int = 1) -> None:
        """src = src^2 * a (a < 2^16)."""

    def square_mul_seq(self, src: Reg, a_vec: Sequence[int]) -> None:
        """src = ((src^2 * a0)^2 * a1)... — fused iteration chain."""
        for a in a_vec:
            self.square_mul(src, int(a))

    def square_sub2_seq(self, src: Reg, count: int) -> None:
        """count iterations of src = src^2 - 2 (the LL step)."""
        for _ in range(count):
            self.square_mul(src)
            self.sub(src, 2)

    @abc.abstractmethod
    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        """dst = spectral form of src (the only legal mul src)."""

    @abc.abstractmethod
    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        """dst = dst * src * a; src must hold a multiplicand."""

    @abc.abstractmethod
    def sub(self, src: Reg, a: int) -> None:
        """src = src - a (small a)."""

    @abc.abstractmethod
    def add_small(self, src: Reg, a: int) -> None:
        """src = src + a (small a)."""

    @abc.abstractmethod
    def add(self, dst: Reg, src: Reg) -> None: ...

    @abc.abstractmethod
    def sub_reg(self, dst: Reg, src: Reg) -> None: ...

    def mul_add(self, dst: Reg, mul_src: Reg, add_src: Reg, a: int = 1) -> None:
        self.mul(dst, mul_src, a)
        self.add(dst, add_src)

    def addsub(self, sum_out: Reg, diff_out: Reg, a: Reg, b: Reg) -> None:
        self.copy(sum_out, a)
        self.copy(diff_out, a)
        self.add(sum_out, b)
        self.sub_reg(diff_out, b)

    def square_mul_copy(self, src: Reg, dst_copy: Reg, a: int = 1) -> None:
        self.square_mul(src, a)
        self.copy(dst_copy, src)

    def mul_copy(self, dst: Reg, src: Reg, dst_copy: Reg, a: int = 1) -> None:
        self.mul(dst, src, a)
        self.copy(dst_copy, dst)

    def pow(self, dst: Reg, src: Reg, e: int) -> None:
        """dst = src^e; src is replaced by its multiplicand form."""
        self.set_multiplicand(src, src)
        self.set(dst, 1)
        if e == 0:
            return
        for i in range(e.bit_length() - 1, -1, -1):
            self.square_mul(dst)
            if (e >> i) & 1:
                self.mul(dst, src)

    def sync(self) -> None:
        pass

    # -- host exchange ------------------------------------------------------
    @abc.abstractmethod
    def get_digits(self, src: Reg) -> np.ndarray:
        """Normalized digit vector (u64 values, widths from self.widths)."""

    @abc.abstractmethod
    def set_digits(self, dst: Reg, digits: np.ndarray) -> None: ...

    def get_int(self, src: Reg) -> int:
        """Value as python int; the all-ones vector (== M_p) maps to 0
        (reference: include/marin/engine.h:183-196)."""
        d = self.get_digits(src)
        masks = (np.uint64(1) << self.widths.astype(np.uint64)) - np.uint64(1)
        if bool((d == masks).all()):
            return 0
        return dg.digits_to_int(d, self.widths)

    def set_int(self, dst: Reg, v: int) -> None:
        mp = (1 << self.p) - 1
        self.set_digits(dst, dg.int_to_digits(v % mp, self.widths))

    def is_equal(self, lhs: Reg, rhs: Reg) -> bool:
        return self.get_int(lhs) == self.get_int(rhs)

    def digit_equal_to(self, src: Reg, a: int) -> bool:
        """Raw digit-vector comparison against small value a
        (reference: include/marin/engine.h:272-283)."""
        d = self.get_digits(src)
        r = a
        for val, w in zip(d.tolist(), self.widths.tolist()):
            if (r & ((1 << int(w)) - 1)) != int(val):
                return False
            r >>= int(w)
        return True

    def digit_equal_to_mp(self, src: Reg) -> bool:
        d = self.get_digits(src)
        masks = (np.uint64(1) << self.widths.astype(np.uint64)) - np.uint64(1)
        return bool((d == masks).all())

    # -- checkpointing -------------------------------------------------------
    def get_checkpoint(self) -> bytes:
        """Register dumps + one trailing flag byte per register marking
        spectral (multiplicand) registers, so a restored engine can rebuild
        prepared multiplicands exactly (the reference dumps registers
        verbatim because its spectral layout is the register layout;
        here the domains differ, so the flag travels with the dump)."""
        out = []
        flags = bytearray()
        for r in range(self.reg_count):
            data, spectral = self.get_raw_tagged(r)
            out.append(data.tobytes())
            flags.append(1 if spectral else 0)
        return b"".join(out) + bytes(flags)

    def set_checkpoint(self, data: bytes) -> None:
        n = self.get_size()
        base = self.reg_count * n * 8
        if len(data) == base + self.reg_count:
            flags = data[base:]
            data = data[:base]
        else:  # legacy dump without the flag block: all digit-domain
            assert len(data) == base
            flags = bytes(self.reg_count)
        arr = np.frombuffer(data, dtype=np.uint64).reshape(self.reg_count, n)
        for r in range(self.reg_count):
            self.set_raw_tagged(r, arr[r], bool(flags[r]))

    def get_raw_tagged(self, src: Reg) -> tuple[np.ndarray, bool]:
        """(raw dump, is_spectral). Base engines only hold digit-domain
        registers; engines with a distinct spectral layout override."""
        return self.get_raw(src), False

    def set_raw_tagged(self, dst: Reg, data: np.ndarray,
                       spectral: bool = False) -> None:
        if spectral:
            raise ValueError(
                "this backend cannot restore spectral registers")
        self.set_raw(dst, data)

    @abc.abstractmethod
    def get_raw(self, src: Reg) -> np.ndarray:
        """Raw register contents (digit or spectral domain), u64 (n,)."""

    @abc.abstractmethod
    def set_raw(self, dst: Reg, data: np.ndarray) -> None: ...
