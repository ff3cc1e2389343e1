"""Interop file formats: GMP-ECM resume lines and Prime95 stage-1 saves.

Byte-exact parity with the reference writers so external tools accept the
files (reference: include/core/AlgoUtils.hpp — ecm_checksum_pminus1 :467,
writeEcmResumeLine :487, hex_to_le_bytes_pad4 :536, checksum_prime95_s1
:631, write_prime95_s1_from_bytes :641, read_prime95_s1_to_bytes :739).
Used for P-1 stage-1 handoff: export X = 3^(E·2p) so GMP-ECM or Prime95
can run stage 2, and import their files to extend B1.
"""

from __future__ import annotations

import struct
import time
import zlib

CHKSUMMOD = 4294967291

PRMERS_TPU_VERSION = "0.1"


# ---------------------------------------------------------------------------
# GMP-ECM resume line (text)
# ---------------------------------------------------------------------------

def ecm_checksum_pm1(b1: int, p: int, x: int) -> int:
    n = ((1 << p) - 1) % CHKSUMMOD
    return (b1 % CHKSUMMOD) * n % CHKSUMMOD * (x % CHKSUMMOD) % CHKSUMMOD


def write_ecm_resume(path: str, b1: int, p: int, x: int) -> None:
    chk = ecm_checksum_pm1(b1, p, x)
    line = (f"METHOD=P-1; B1={b1}; N=2^{p}-1; X=0x{x:x}; "
            f"CHECKSUM={chk}; PROGRAM=PrMers; X0=0x3; Y=0x0; Y0=0x0; "
            f"WHO=; TIME=;")
    with open(path, "w") as f:
        f.write(line + "\n")


def convert_mers_to_save(mers_path: str, out_path: str = "") -> str:
    """Convert a PrMers `.mers` checkpoint (the raw little-endian u64
    digit vector of the stage-1 residue; filename <p>pm<B1>.mers) to a
    GMP-ECM .save resume line; returns the output path (reference:
    App::exportResumeFromMersFile, src/core/App.cpp:520-553 +
    AlgoUtils.hpp:510 read_mers_file)."""
    import os
    import numpy as np
    from ..core.plan import digit_widths
    from ..utils import digits as dgu

    fname = os.path.basename(mers_path)
    stem, dot, ext = fname.rpartition(".")
    if ext != "mers" or "pm" not in stem:
        raise ValueError("invalid filename format, expected <p>pm<B1>.mers")
    p_str, _, b1_str = stem.partition("pm")
    p, b1 = int(p_str), int(b1_str)
    v = np.fromfile(mers_path, dtype="<u8")
    if v.size < 1:
        raise ValueError(f"file too small: {mers_path}")
    widths = digit_widths(p, int(v.size))
    mp = (1 << p) - 1
    x = dgu.digits_to_int(v, widths) % mp
    out = out_path or os.path.join(os.path.dirname(mers_path) or ".",
                                   stem + ".save")
    write_ecm_resume(out, b1, p, x)
    return out


def write_ecm_resume_ecm(path: str, b1: int, p: int, x_aff: int,
                         a: int | None = None,
                         sigma: int | None = None) -> None:
    """Append a METHOD=ECM stage-1 resume line (GMP-ECM format) so an
    external stage 2 can continue a curve: SIGMA lines for Suyama
    curves, A= lines for A-based/custom families (reference:
    src/modes/RunEcm.cpp:1025-1085 — note the A-variant checksum skips
    the curve parameter)."""
    n = ((1 << p) - 1) % CHKSUMMOD
    if sigma is not None:
        chk = (b1 % CHKSUMMOD) * (sigma % CHKSUMMOD) % CHKSUMMOD \
            * n % CHKSUMMOD * (x_aff % CHKSUMMOD) % CHKSUMMOD
        body = (f"METHOD=ECM; SIGMA={sigma}; B1={b1}; N=2^{p}-1; "
                f"X=0x{x_aff:x}; CHECKSUM={chk}; "
                f"PROGRAM=PrMers; X0=0x0; Y0=0x0; TIME=;")
    else:
        chk = (b1 % CHKSUMMOD) * n % CHKSUMMOD \
            * (x_aff % CHKSUMMOD) % CHKSUMMOD
        body = (f"METHOD=ECM; B1={b1}; N=2^{p}-1; X=0x{x_aff:x}; "
                f"A={a}; CHECKSUM={chk}; "
                f"PROGRAM=PrMers; X0=0x0; Y0=0x0; TIME=;")
    with open(path, "a") as f:
        f.write(body + "\n")


def read_ecm_resume(path: str) -> tuple[int, int, int]:
    """(b1, p, x) from a GMP-ECM P-1 resume line; checksum-verified when a
    CHECKSUM field is present. Raises ValueError on malformed input."""
    with open(path) as f:
        line = f.readline()
    fields = {}
    for tok in line.strip().split(";"):
        tok = tok.strip()
        if "=" in tok:
            k, v = tok.split("=", 1)
            fields[k.strip()] = v.strip()
    if fields.get("METHOD") != "P-1":
        raise ValueError("not a P-1 resume line")
    b1 = int(fields["B1"])
    nstr = fields["N"]
    if not (nstr.startswith("2^") and nstr.endswith("-1")):
        raise ValueError(f"unsupported modulus {nstr!r} (Mersenne only)")
    p = int(nstr[2:-2])
    xs = fields["X"]
    x = int(xs, 16) if xs.lower().startswith("0x") else int(xs)
    if "CHECKSUM" in fields:
        if int(fields["CHECKSUM"]) != ecm_checksum_pm1(b1, p, x):
            raise ValueError("resume line checksum mismatch")
    return b1, p, x


# ---------------------------------------------------------------------------
# Prime95 stage-1 save (binary)
# ---------------------------------------------------------------------------

def x_to_le_bytes_pad4(x: int) -> bytes:
    """Little-endian bytes of x padded to a 4-byte multiple (the
    reference pads the hex string to 8-nibble groups)."""
    hexs = f"{x:x}"
    if len(hexs) & 1:
        hexs = "0" + hexs
    pad = (8 - (len(hexs) & 7)) & 7
    hexs = "0" * pad + hexs
    return bytes.fromhex(hexs)[::-1]


def checksum_prime95_s1(b1: int, data: bytes) -> int:
    sum32 = 0
    for i in range(0, len(data) - 3, 4):
        sum32 += struct.unpack_from("<I", data, i)[0]
    return ((b1 << 1) + 6 + (len(data) >> 1) + sum32) & 0xFFFFFFFF


def write_prime95_s1(path: str, p: int, b1: int, x: int,
                     date_start: str = "", date_end: str = "") -> None:
    data = x_to_le_bytes_pad4(x)
    chk = checksum_prime95_s1(b1, data)
    out = bytearray()
    out += struct.pack("<II", 830093643, 8)
    out += struct.pack("<d", 1.0)
    out += struct.pack("<i", 2)
    out += struct.pack("<I", p)
    out += struct.pack("<i", -1)
    out += b"S1"
    out += struct.pack("<H", 0)
    out += struct.pack("<Q", 0)
    out += struct.pack("<d", 1.0)
    out += struct.pack("<I", chk)
    out += struct.pack("<i", 5)
    out += struct.pack("<QQ", b1, b1)
    out += struct.pack("<ii", 1, len(data) >> 2)
    out += data

    ts = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime()) + ".000"
    ds = date_start or ts
    de = date_end or ts
    json = (',"programs":[{"work":{"type":"PM1","stage":"1"},'
            '"program":{"name":"prmers","version":"'
            + PRMERS_TPU_VERSION + '"},"os":{"os":"Linux",'
            '"architecture":"x86_64"},"date_start":"' + ds +
            '","date_end":"' + de + '"}]')
    jb = json.encode()
    out += b"MOREINFOJSONDATA"
    out += struct.pack("<III", 8 + len(jb), 1, zlib.crc32(jb) & 0xFFFFFFFF)
    out += jb
    with open(path, "wb") as f:
        f.write(out)


def read_prime95_s1(path: str) -> tuple[int, int, int]:
    """(p, b1, x) from a Prime95 stage-1 save; validates magic + checksum."""
    with open(path, "rb") as f:
        blob = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        v = struct.unpack_from(fmt, blob, off)
        off += struct.calcsize(fmt)
        return v if len(v) > 1 else v[0]

    magic = take("<I")
    if magic != 830093643:
        raise ValueError("not a Prime95 P-1 save file")
    take("<I")           # version
    take("<d")
    take("<i")
    p = take("<I")
    take("<i")
    stage = blob[off:off + 2]
    off += 2
    if stage != b"S1":
        raise ValueError(f"unsupported Prime95 stage {stage!r}")
    take("<H")
    take("<Q")
    take("<d")
    chk_file = take("<I")
    take("<i")
    b1, _b1b = take("<QQ")
    take("<ii")
    nwords = struct.unpack_from("<i", blob, off - 4)[0]
    data = blob[off:off + 4 * nwords]
    off += 4 * nwords
    if checksum_prime95_s1(b1, data) != chk_file:
        raise ValueError("Prime95 save checksum mismatch")
    x = int.from_bytes(data, "little")
    return p, b1, x
