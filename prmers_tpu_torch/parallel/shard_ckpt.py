"""Sharded checkpoint save/load: per-process shard files + a manifest.

At flagship scale a full-register gather through one host does not fit
(n = 2^26 x 51 ECM registers ~ 27 GB); instead every PROCESS writes the
digit ranges its devices own to its own file, and the primary writes a
manifest mapping digit ranges to files. Loading is process-count
INDEPENDENT: each process reads exactly the ranges its (possibly
different) mesh partition needs, so a run checkpointed on H hosts resumes
on H' hosts (SURVEY §5.4 checkpoint parity extended to the distributed
layer; the reference is single-GPU — include/marin/file.h:16-45 is the
integrity model being mirrored: CRC32 per file, atomic rename).

Layout of <dir>/:
  manifest.json               (primary only; written LAST = commit point)
  shard_<proc>.bin            one per process: concatenated u64-LE digit
                              ranges in manifest order, CRC32 trailer

Port: a copy of prmers_tpu/parallel/shard_ckpt.py with these changes.
  * A process is a rank of parallel/dist (one card each), so the
    process index is dist.rank(), and each rank owns one contiguous digit
    range of every register: the same n/s digits on both mesh engines
    (parallel/mesh_engine.MeshEngine's r1 shard, parallel/sharded.
    ShardedEngine's slab row).
  * _reg_digit_rows: MeshEngine's settled digits (its pending carries
    folded in by _settled, a collective: every rank calls it), or a
    multiplicand's spectral values canonical mod P; ShardedEngine's row
    as it stands; an engine with one (reg_count, n) slab of digits
    (engine/torch_engine.TorchEngine, the reference's single-device jax
    arrays) as one range from 0. Any other engine raises TypeError.
  * _set_reg_scattered: jax.make_array_from_callback becomes "each rank
    reads the range it owns" (_ShardReader.read_range) and sets it.
  * The files are the reference's byte for byte, so a store either
    package writes loads into the other.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import torch

from ..ops import gl64 as gl
from . import dist


def _is_mesh(eng) -> bool:
    return hasattr(eng, "_settled")         # MeshEngine


def _reg_digit_rows(eng, r: int):
    """[(start_digit, u64 digits)] for the locally-owned pieces of
    register r, in canonical digit order, plus the spectral flag."""
    if _is_mesh(eng):
        st = eng.regs[r]
        spectral = bool(st[2])
        x = gl.canon64(st[0]) if spectral else eng._settled(r)
        start = dist.rank() * x.numel()
        return [(start, gl.to_numpy_u64(x).reshape(-1))], spectral
    regs = getattr(eng, "regs", None)
    if not isinstance(regs, torch.Tensor) or regs.dim() != 2:
        raise TypeError(f"{type(eng).__name__} has no sharded digit rows")
    spectral = r in getattr(eng, "_spec", set())
    row = regs[r]
    return [(dist.rank() * row.numel(), gl.to_numpy_u64(row))], spectral


def save_sharded(eng, dir_path: str, meta: dict) -> None:
    """Write a sharded checkpoint of every register. `meta` is the
    mode-level state (iteration, elapsed, extra...), stored verbatim in
    the manifest. Atomic: the manifest is written last; a directory
    without a manifest is an aborted save."""
    os.makedirs(dir_path, exist_ok=True)
    proc = dist.rank()
    entries = []        # [(reg, start, count)] in file order
    chunks = []
    spectral = {}
    for r in range(eng.reg_count):
        rows, is_spec = _reg_digit_rows(eng, r)
        spectral[r] = is_spec
        for start, data in rows:
            entries.append((r, int(start), int(data.size)))
            chunks.append(data.astype("<u8").tobytes())
    payload = b"".join(chunks)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    fname = f"shard_{proc}.bin"
    tmp = os.path.join(dir_path, fname + ".new")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.write(struct.pack("<I", crc))
    os.replace(tmp, os.path.join(dir_path, fname))

    # every process reports its entry table to the manifest through the
    # filesystem (process-local sidecars), primary commits the manifest
    side = os.path.join(dir_path, f"entries_{proc}.json")
    with open(side + ".new", "w") as f:
        json.dump(entries, f)
    os.replace(side + ".new", side)
    dist.barrier("shard_ckpt_files")

    if dist.is_primary():
        files = {}
        nproc = dist.process_count()
        for q in range(nproc):
            with open(os.path.join(dir_path, f"entries_{q}.json")) as f:
                files[f"shard_{q}.bin"] = json.load(f)
        manifest = {
            "version": 1,
            "p": eng.p,
            "n": eng.get_size(),
            "reg_count": eng.reg_count,
            "spectral": {str(k): v for k, v in spectral.items()},
            "meta": meta,
            "files": files,
        }
        tmp = os.path.join(dir_path, "manifest.json.new")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(dir_path, "manifest.json"))
    dist.barrier("shard_ckpt_commit")


class _ShardReader:
    """Random access into the shard files by (reg, digit range)."""

    def __init__(self, dir_path: str, manifest: dict):
        self.dir = dir_path
        # per reg: [(start, count, fname, byte_offset)]
        self.index: dict[int, list] = {}
        for fname, entries in manifest["files"].items():
            off = 0
            for reg, start, count in entries:
                self.index.setdefault(int(reg), []).append(
                    (int(start), int(count), fname, off))
                off += int(count) * 8
        for v in self.index.values():
            v.sort()
        self._fh = {}

    def _file(self, fname):
        if fname not in self._fh:
            self._fh[fname] = open(os.path.join(self.dir, fname), "rb")
        return self._fh[fname]

    def read_range(self, reg: int, start: int, count: int) -> np.ndarray:
        """u64 digits [start, start+count) of register reg, assembled
        from whichever files hold pieces of the range."""
        out = np.empty(count, dtype=np.uint64)
        filled = 0
        for estart, ecount, fname, off in self.index.get(reg, []):
            lo = max(start, estart)
            hi = min(start + count, estart + ecount)
            if lo >= hi:
                continue
            f = self._file(fname)
            f.seek(off + (lo - estart) * 8)
            buf = f.read((hi - lo) * 8)
            out[lo - start:hi - start] = np.frombuffer(buf, dtype="<u8")
            filled += hi - lo
        if filled != count:
            raise ValueError(
                f"checkpoint hole: reg {reg} range [{start},{start+count})"
                f" only {filled} digits present")
        return out

    def close(self):
        for f in self._fh.values():
            f.close()
        self._fh = {}


def verify_files(dir_path: str, manifest: dict) -> bool:
    """CRC32 check of every shard file present on this host (files for
    other hosts' shards may legitimately be absent on a shared-nothing
    filesystem — only the ranges a process reads need its files)."""
    for fname in manifest["files"]:
        path = os.path.join(dir_path, fname)
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            blob = f.read()
        payload, crc = blob[:-4], struct.unpack("<I", blob[-4:])[0]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return False
    return True


def load_sharded(eng, dir_path: str) -> dict | None:
    """Restore every register into `eng` (any process count / mesh
    partition). Returns the saved meta dict, or None if the directory
    has no committed manifest / fails integrity. Each process reads only
    the digit range it owns."""
    mpath = os.path.join(dir_path, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if manifest.get("version") != 1 or manifest["p"] != eng.p or \
            manifest["n"] != eng.get_size() or \
            manifest["reg_count"] != eng.reg_count:
        return None
    if not verify_files(dir_path, manifest):
        return None
    reader = _ShardReader(dir_path, manifest)
    try:
        for r in range(eng.reg_count):
            spectral = manifest["spectral"].get(str(r), False)
            _set_reg_scattered(eng, r, reader, spectral)
    finally:
        reader.close()
    return manifest["meta"]


def _set_reg_scattered(eng, r: int, reader: _ShardReader,
                       spectral: bool) -> None:
    """Register r from the store: this rank reads its own n/s digits."""
    m = eng.get_size() // dist.process_count()
    d = reader.read_range(r, dist.rank() * m, m)
    if _is_mesh(eng):
        x = gl.from_numpy_u64(d, eng.device).reshape(eng.tables.shape)
        eng.regs[r] = [x, None, True] if spectral else [x, eng._zc(), False]
        return
    eng.regs[r].copy_(gl.from_numpy_u64(d, eng.regs.device))
    spec = getattr(eng, "_spec", None)
    if spec is not None:
        if spectral:
            spec.add(r)
        else:
            spec.discard(r)
    elif spectral:
        raise ValueError(f"{type(eng).__name__} cannot restore a "
                         "spectral register")
