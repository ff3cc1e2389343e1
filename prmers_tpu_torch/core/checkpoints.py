"""Versioned binary checkpoints with CRC32 integrity and atomic rotation.

Layout parity with the reference checkpoint scheme
(reference: src/modes/RunPrpOrLlMarin.cpp:156-214, include/marin/file.h:16-45):
  int32 version | u32 p | u32 mode_tag | u32 backend_tag | u32 iter |
  f64 elapsed | [extra (mode-specific) block] | register dump | u32 crc32
Rotation: write .new, move current -> .old, move .new -> current.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

from ..parallel import dist

VERSION = 2

MODE_TAGS = {"prp": 1, "ll": 2, "llsafe": 3, "llsafe2": 4, "pm1": 5,
             "pm1s2": 6, "ecm": 7, "wagstaff": 8}
BACKEND_TAG_JAX = 3


@dataclass
class CheckpointData:
    p: int
    mode_tag: int
    iteration: int
    elapsed: float
    extra: bytes
    regs: bytes


def ckpt_filename(p: int, mode: str, wagstaff: bool = False,
                  save_dir: str = ".") -> str:
    prefix = ""
    if wagstaff:
        prefix += "wagstaff_"
    if mode == "ll":
        prefix += "llunsafe_"
    elif mode == "llsafe":
        prefix += "llsafe_"
    elif mode == "llsafe2":
        prefix += "llsafe2_"
    elif mode == "pm1":
        prefix += "pm1_"
    elif mode == "pm1s2":
        prefix += "pm1_s2_"
    elif mode == "ecm":
        prefix += "ecm_"
    return os.path.join(save_dir, f"{prefix}m_{p}.ckpt")


def write_checkpoint(path: str, data: CheckpointData) -> None:
    if not dist.is_primary():
        # on the mesh every rank gathers the same register state, so rank
        # 0 alone writes the file
        return
    payload = struct.pack(
        "<iIIIId",
        VERSION, data.p, data.mode_tag, BACKEND_TAG_JAX,
        data.iteration & 0xFFFFFFFF, data.elapsed,
    )
    payload += struct.pack("<I", len(data.extra)) + data.extra
    payload += data.regs
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)   # a fresh -save-dir must not abort
    newf, oldf = path + ".new", path + ".old"
    with open(newf, "wb") as f:
        f.write(payload)
        f.write(struct.pack("<I", crc))
    if os.path.exists(oldf):
        os.remove(oldf)
    if os.path.exists(path):
        os.rename(path, oldf)
    os.rename(newf, path)


def read_checkpoint(path: str, p: int, mode_tag: int) -> CheckpointData | None:
    """Returns None if missing/incompatible/corrupt (never raises on bad data)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
        if len(blob) < 29:
            return None
        payload, crc_stored = blob[:-4], struct.unpack("<I", blob[-4:])[0]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc_stored:
            return None
        version, rp, m, backend, it, elapsed = struct.unpack_from("<iIIIId", payload, 0)
        if version != VERSION or rp != p or m != mode_tag:
            return None
        if backend != BACKEND_TAG_JAX:
            return None
        off = struct.calcsize("<iIIIId")
        (extra_len,) = struct.unpack_from("<I", payload, off)
        off += 4
        extra = payload[off:off + extra_len]
        regs = payload[off + extra_len:]
        return CheckpointData(p=rp, mode_tag=m, iteration=it,
                              elapsed=elapsed, extra=extra, regs=regs)
    except OSError:
        return None


def load_latest(path: str, p: int, mode_tag: int) -> CheckpointData | None:
    ck = read_checkpoint(path, p, mode_tag)
    if ck is None:
        ck = read_checkpoint(path + ".old", p, mode_tag)
    return ck


def delete_checkpoints(path: str) -> None:
    if not dist.is_primary():
        return          # rank 0 alone writes them, and removes them
    for f in (path, path + ".old", path + ".new"):
        if os.path.exists(f):
            os.remove(f)
