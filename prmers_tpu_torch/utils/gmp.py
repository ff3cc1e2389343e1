"""ctypes binding to the system libgmp for host big-integer arithmetic.

CPython's pure-Python ints are fine below ~2^20 bits, but a single
Karatsuba square at Mersenne scale (p ~ 1.4e8 bits) takes minutes and a
gcd is hopeless. The reference links GMP for exactly these host jobs
(reference: src/util/GmpUtils.cpp, include/core/AlgoUtils.hpp — final
PRP reduction, Gerbicz compares, P-1/ECM gcds, proof exponentiation).

Only the handful of entry points the framework needs are bound; every
function takes/returns Python ints (non-negative). If libgmp is absent
the pure-Python fallbacks keep everything working, just slower.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

__all__ = ["HAVE_GMP", "mul", "mulmod", "sqrmod", "powmod", "gcd",
           "mod", "invert", "mersenne_mod"]

_lib = None
for _name in ("libgmp.so.10", "libgmp.so", ctypes.util.find_library("gmp")):
    if not _name:
        continue
    try:
        _lib = ctypes.CDLL(_name)
        break
    except OSError:
        continue

HAVE_GMP = _lib is not None


class _MpzT(ctypes.Structure):
    _fields_ = [("_mp_alloc", ctypes.c_int),
                ("_mp_size", ctypes.c_int),
                ("_mp_d", ctypes.c_void_p)]


# NOTE: attribute access like `_lib.__gmpz_init` inside a class body would
# be name-mangled by Python; always bind through getattr at module scope.
if HAVE_GMP:
    _p = ctypes.POINTER(_MpzT)
    _init = getattr(_lib, "__gmpz_init")
    _clear = getattr(_lib, "__gmpz_clear")
    _import_ = getattr(_lib, "__gmpz_import")
    _export = getattr(_lib, "__gmpz_export")
    _sizeinbase = getattr(_lib, "__gmpz_sizeinbase")
    _mul = getattr(_lib, "__gmpz_mul")
    _mod = getattr(_lib, "__gmpz_mod")
    _gcd = getattr(_lib, "__gmpz_gcd")
    _powm = getattr(_lib, "__gmpz_powm")
    _invert_ = getattr(_lib, "__gmpz_invert")
    _init.argtypes = [_p]
    _clear.argtypes = [_p]
    _import_.argtypes = [_p, ctypes.c_size_t, ctypes.c_int,
                         ctypes.c_size_t, ctypes.c_int,
                         ctypes.c_size_t, ctypes.c_void_p]
    _export.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
                        ctypes.c_int, ctypes.c_size_t,
                        ctypes.c_int, ctypes.c_size_t, _p]
    _export.restype = ctypes.c_void_p
    _sizeinbase.argtypes = [_p, ctypes.c_int]
    _sizeinbase.restype = ctypes.c_size_t
    for _f in (_mul, _mod, _gcd):
        _f.argtypes = [_p, _p, _p]
    _powm.argtypes = [_p, _p, _p, _p]
    _invert_.argtypes = [_p, _p, _p]
    _invert_.restype = ctypes.c_int


class _Z:
    """Scoped mpz_t; imports from / exports to Python int (>= 0)."""

    __slots__ = ("z",)

    def __init__(self, value: int | None = None):
        self.z = _MpzT()
        _init(ctypes.byref(self.z))
        if value is not None and value != 0:
            buf = value.to_bytes((value.bit_length() + 7) // 8, "little")
            _import_(ctypes.byref(self.z), len(buf), -1, 1, 0, 0, buf)

    def to_int(self) -> int:
        if self.z._mp_size == 0:
            return 0
        nbytes = (_sizeinbase(ctypes.byref(self.z), 2) + 7) // 8
        buf = ctypes.create_string_buffer(int(nbytes))
        cnt = ctypes.c_size_t(0)
        _export(buf, ctypes.byref(cnt), -1, 1, 0, 0, ctypes.byref(self.z))
        return int.from_bytes(buf.raw[:cnt.value], "little")

    def __del__(self):
        try:
            _clear(ctypes.byref(self.z))
        except Exception:
            pass


def mul(a: int, b: int) -> int:
    if not HAVE_GMP:
        return a * b
    za, zb, zr = _Z(a), _Z(b), _Z()
    _mul(ctypes.byref(zr.z), ctypes.byref(za.z), ctypes.byref(zb.z))
    return zr.to_int()


def mod(a: int, m: int) -> int:
    if not HAVE_GMP:
        return a % m
    za, zm, zr = _Z(a), _Z(m), _Z()
    _mod(ctypes.byref(zr.z), ctypes.byref(za.z), ctypes.byref(zm.z))
    return zr.to_int()


def mulmod(a: int, b: int, m: int) -> int:
    if not HAVE_GMP:
        return (a * b) % m
    za, zb, zm = _Z(a), _Z(b), _Z(m)
    zr = _Z()
    _mul(ctypes.byref(zr.z), ctypes.byref(za.z), ctypes.byref(zb.z))
    _mod(ctypes.byref(zr.z), ctypes.byref(zr.z), ctypes.byref(zm.z))
    return zr.to_int()


def sqrmod(a: int, m: int) -> int:
    return mulmod(a, a, m)


def powmod(b: int, e: int, m: int) -> int:
    if not HAVE_GMP:
        return pow(b, e, m)
    zb, ze, zm, zr = _Z(b), _Z(e), _Z(m), _Z()
    _powm(ctypes.byref(zr.z), ctypes.byref(zb.z), ctypes.byref(ze.z),
          ctypes.byref(zm.z))
    return zr.to_int()


def gcd(a: int, b: int) -> int:
    if not HAVE_GMP:
        return math.gcd(a, b)
    za, zb, zr = _Z(a), _Z(b), _Z()
    _gcd(ctypes.byref(zr.z), ctypes.byref(za.z), ctypes.byref(zb.z))
    return zr.to_int()


def invert(a: int, m: int) -> int:
    """a^-1 mod m; raises ValueError when not invertible (like pow(a,-1,m))."""
    if not HAVE_GMP:
        return pow(a, -1, m)
    za, zm, zr = _Z(a), _Z(m), _Z()
    ok = _invert_(ctypes.byref(zr.z), ctypes.byref(za.z), ctypes.byref(zm.z))
    if not ok:
        raise ValueError("base is not invertible for the given modulus")
    return zr.to_int()


def mersenne_mod(a: int, p: int) -> int:
    """a mod (2^p - 1) by shift-fold (no division; fast in pure Python
    too, but GMP's shifts still win at scale — plain mod here)."""
    mp_ = (1 << p) - 1
    while a.bit_length() > p:
        a = (a & mp_) + (a >> p)
    if a == mp_:
        return 0
    return a
