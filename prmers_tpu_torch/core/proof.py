"""GIMPS PRP proof (Pietrzak VDF) — generation, file format, verification.

Format and algorithm parity with the reference (GPUOwl-compatible):
  * checkpoint points via halving spans (reference:
    src/core/ProofSetMarin.cpp:62-95 construction, isInPoints :146-158)
  * power = 10 + floor(log4(E/60M)), clamped to [2, 12]
    (ProofSetMarin.cpp:133-141)
  * residue files "<E>/proof/<iter>": CRC32 + (E+31)/32 u32 words
    (ProofSetMarin.cpp:100-123)
  * middles via the binary-tree expMul walk with a SHA3-256 hash chain
    (computeProof, ProofSetMarin.cpp:213-310); h = first 8 bytes (LE) of
    SHA3-256(prev_hash_32B || residue_bytes), residue_bytes = first
    (E-1)/8+1 bytes of the little-endian value
  * proof file "PRP PROOF/VERSION=2/HASHSIZE=64/POWER=k/NUMBER=M<E>[/f...]"
    + packed B + middles (ProofMarin.cpp:34-90)
  * verify: A=3, B=final; per middle: h = chained hash;
    B <- M^h * (B^2 if span odd else B); A <- A^h * M; span <- (span+1)/2;
    accept iff A^(2^span) == B (Proof.cpp:247-345)

Host arithmetic uses python ints (mersenne reduction is trivial);
verification's long squaring chain can run on an Engine when provided.

Port: a copy of prmers_tpu/core/proof.py with these changes.
  * The packed residue file is written by rank 0 alone (parallel/dist):
    checkpoint_engine, the reference's as it is, gathers the register
    through eng.get_digits, which on the mesh every rank calls (a
    collective), and checkpoint returns on the other ranks.
  * The per-process digit shards of :164-176 are parallel/shard_ckpt's
    rows of the port's engines (MeshEngine, ShardedEngine, TorchEngine's
    slab): one range per rank. An engine without such rows raises
    TypeError there, which falls back to the packed file as the
    reference's AttributeError/TypeError does.
  * The shard writer's process index (:192-193) is dist.rank(), and its
    barriers are dist.barrier(tag); shard stores the JAX package wrote
    load, and the JAX package loads the port's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
import zlib

from ..parallel import dist as _dist
from ..utils import digits as dg


from ..utils import gmp

def mersenne_reduce(v: int, p: int) -> int:
    m = (1 << p) - 1
    while v >> p:
        v = (v & m) + (v >> p)
    return v if v != m else 0


def best_power(E: int) -> int:
    import math
    power = 10 + math.floor(math.log2(E / 60e6) / 2) if E > 0 else 2
    return max(2, min(12, int(power)))


def proof_spans(E: int, power: int) -> list[int]:
    spans = []
    span = (E + 1) // 2
    for _ in range(power):
        spans.append(span)
        span = (span + 1) // 2
    return spans


def proof_points(E: int, power: int) -> list[int]:
    points = [0]
    for span in proof_spans(E, power):
        points += [pt + span for pt in points]
    points[0] = E
    points.sort()
    return points


def is_in_points(E: int, power: int, k: int) -> bool:
    if k == E:
        return True
    start = 0
    for span in proof_spans(E, power):
        if k > start + span:
            start += span
        elif k == start + span:
            return True
    return False


def _nwords(E: int) -> int:
    return (E + 31) // 32


def _nbytes(E: int) -> int:
    return (E - 1) // 8 + 1


def _words_bytes(v: int, E: int) -> bytes:
    """Value as the reference's u32-word buffer bytes (LE, padded)."""
    return (v % ((1 << E) - 1)).to_bytes(_nwords(E) * 4, "little")


def _hash_words(E: int, v: int, prefix: bytes | None = None) -> bytes:
    h = hashlib.sha3_256()
    if prefix is not None:
        h.update(prefix)
    h.update(_words_bytes(v, E)[:_nbytes(E)])
    return h.digest()


def _h64(digest: bytes) -> int:
    return int.from_bytes(digest[:8], "little")


def res64(v: int) -> int:
    return v & 0xFFFFFFFFFFFFFFFF


class ProofSet:
    """Residue checkpoint store for proof generation.

    Interface consumed by the PRP driver: should_checkpoint(iter),
    next_checkpoint_after(iter), checkpoint(digits_or_int, iter).
    """

    def __init__(self, E: int, power: int, widths=None, save_dir: str = ".",
                 known_factors: tuple[str, ...] = ()):
        self.E = E
        self.power = power
        self.widths = widths
        self.known_factors = known_factors
        self.dir = os.path.join(save_dir, str(E), "proof")
        os.makedirs(self.dir, exist_ok=True)
        self.points = proof_points(E, power)

    def _file(self, k: int) -> str:
        return os.path.join(self.dir, str(k))

    def should_checkpoint(self, it: int) -> bool:
        return is_in_points(self.E, self.power, it)

    def next_checkpoint_after(self, it: int) -> int | None:
        for pt in self.points:
            if pt > it:
                return pt
        return None

    def checkpoint(self, digits_or_int, it: int) -> None:
        if not self.should_checkpoint(it) or not _dist.is_primary():
            return
        if isinstance(digits_or_int, int):
            v = digits_or_int
        else:
            v = dg.digits_to_int(digits_or_int, self.widths)
        buf = _words_bytes(v, self.E)
        crc = zlib.crc32(buf) & 0xFFFFFFFF
        with open(self._file(it), "wb") as f:
            f.write(struct.pack("<I", crc))
            f.write(buf)

    def checkpoint_engine(self, eng, it: int, reg: int = 0) -> None:
        """Residue checkpoint directly from an engine register.

        Multi-host mesh runs (or PRMERS_PROOF_SHARDED=1) write
        per-process digit-shard files instead of gathering the full
        residue through the primary host: at p ~ 1G, power 10-12 the
        gathered store is a ~10 GB-class primary bill per run (VERDICT
        r4 weak #6); shards move only each host's own digit ranges and
        the full residue materializes once, at proof-compute time on
        the primary. Single-process runs keep the packed uint32-words
        file (reference layout, ProofSetMarin.cpp:100-123)."""
        if not self.should_checkpoint(it):
            return
        from ..parallel import dist as _dist
        sharded = (os.environ.get("PRMERS_PROOF_SHARDED") == "1"
                   or _dist.process_count() > 1)
        if sharded:
            from ..parallel import shard_ckpt
            try:
                rows, spectral = shard_ckpt._reg_digit_rows(eng, reg)
            except (AttributeError, TypeError):
                rows = None     # engine has no sharded digit rows
            if rows is not None:
                assert not spectral, "proof residue must be digit-domain"
                self._write_shards(it, rows)
                return
        self.checkpoint(eng.get_digits(reg), it)

    def _shard_dir(self, it: int) -> str:
        return self._file(it) + ".shards"

    def _write_shards(self, it: int, rows) -> None:
        """Per-process residue shard: [(start u64, count u64, digits...)]
        ranges + CRC32 trailer; the primary commits a manifest last
        (same atomicity model as parallel/shard_ckpt.py)."""
        import json
        dirp = self._shard_dir(it)
        os.makedirs(dirp, exist_ok=True)
        proc = _dist.rank()
        parts = []
        entries = []
        for start, data in rows:
            entries.append((int(start), int(data.size)))
            parts.append(struct.pack("<QQ", int(start), int(data.size)))
            parts.append(data.astype("<u8").tobytes())
        payload = b"".join(parts)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        fn = os.path.join(dirp, f"shard_{proc}.bin")
        with open(fn + ".new", "wb") as f:
            f.write(payload)
            f.write(struct.pack("<I", crc))
        os.replace(fn + ".new", fn)
        _dist.barrier("proof_shard_files")
        if _dist.is_primary():
            manifest = {"E": self.E, "iter": it,
                        "nproc": _dist.process_count()}
            tmp = os.path.join(dirp, "manifest.json.new")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, os.path.join(dirp, "manifest.json"))
        _dist.barrier("proof_shard_commit")

    def _load_shards(self, it: int) -> int:
        import json
        import numpy as np
        dirp = self._shard_dir(it)
        with open(os.path.join(dirp, "manifest.json")) as f:
            man = json.load(f)
        assert man["E"] == self.E and man["iter"] == it
        assert self.widths is not None, \
            "sharded proof residues need the plan widths to stitch"
        n = len(self.widths)
        digits = np.zeros(n, dtype=np.uint64)
        seen = 0
        for q in range(man["nproc"]):
            with open(os.path.join(dirp, f"shard_{q}.bin"), "rb") as f:
                blob = f.read()
            payload, (crc,) = blob[:-4], struct.unpack("<I", blob[-4:])
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError(
                    f"CRC mismatch in proof residue shard {it}/{q}")
            off = 0
            while off < len(payload):
                start, count = struct.unpack_from("<QQ", payload, off)
                off += 16
                digits[start:start + count] = np.frombuffer(
                    payload, dtype="<u8", count=count, offset=off)
                off += count * 8
                seen += count
        assert seen == n, f"residue shards cover {seen}/{n} digits"
        # no mod-M_p fold: parity with the packed-words path, which
        # stores the canonical digit value verbatim (all-ones == M_p)
        return dg.digits_to_int(digits, self.widths)

    def load(self, it: int) -> int:
        if not os.path.exists(self._file(it)) and \
                os.path.exists(os.path.join(self._shard_dir(it),
                                            "manifest.json")):
            return self._load_shards(it)
        with open(self._file(it), "rb") as f:
            blob = f.read()
        crc = struct.unpack_from("<I", blob, 0)[0]
        buf = blob[4:]
        if zlib.crc32(buf) & 0xFFFFFFFF != crc:
            raise ValueError(f"CRC mismatch in proof residue {it}")
        return int.from_bytes(buf, "little")

    def is_complete(self) -> bool:
        return all(os.path.exists(self._file(pt)) or
                   os.path.exists(os.path.join(self._shard_dir(pt),
                                               "manifest.json"))
                   for pt in self.points)

    def compute_proof(self, log=print) -> "Proof":
        """Binary-tree middle construction (reference computeProof,
        ProofSetMarin.cpp:213-310)."""
        E, power = self.E, self.power
        mp = (1 << E) - 1
        B = self.load(E)
        hash_ = _hash_words(E, B)
        hashes: list[int] = []
        middles: list[int] = []
        for p in range(power):
            s = 1 << (power - p - 1)
            bufs: list[int] = []
            for i in range(1 << p):
                idx = s * (i * 2 + 1) - 1
                if idx >= len(self.points):
                    continue
                it = self.points[idx]
                if it > E or not self.should_checkpoint(it):
                    continue
                bufs.append(self.load(it))
                k = 0
                while i & (1 << k):
                    b = bufs.pop()
                    a = bufs.pop()
                    h = hashes[p - 1 - k]
                    bufs.append(mersenne_reduce(gmp.mul(gmp.powmod(a, h, mp), b), E))
                    k += 1
            assert len(bufs) == 1, f"proof tree imbalance at level {p}"
            middle = bufs[0] % mp
            if middle == 0:
                raise RuntimeError(f"zero residue during proof at level {p}")
            middles.append(middle)
            hash_ = _hash_words(E, middle, prefix=hash_)
            h = _h64(hash_)
            hashes.append(h)
            log(f"proof [{p}] : M {res64(middle):016x}, h {h:016x}")
        return Proof(E=E, B=B, middles=middles,
                     known_factors=self.known_factors)


@dataclasses.dataclass
class Proof:
    E: int
    B: int
    middles: list[int]
    known_factors: tuple[str, ...] = ()

    @property
    def power(self) -> int:
        return len(self.middles)

    def filename(self, save_dir: str = ".") -> str:
        return os.path.join(save_dir, f"m{self.E}-{self.power}.proof")

    def save(self, path: str | None = None) -> str:
        path = path or self.filename()
        E = self.E
        nb = _nbytes(E)
        with open(path, "wb") as f:
            num = f"M{E}"
            for fac in self.known_factors:
                num += f"/{fac}"
            f.write(f"PRP PROOF\nVERSION=2\nHASHSIZE=64\nPOWER="
                    f"{self.power}\nNUMBER={num}\n".encode())
            f.write(_words_bytes(self.B, E)[:nb])
            for m in self.middles:
                f.write(_words_bytes(m, E)[:nb])
        return path

    @classmethod
    def load(cls, path: str) -> "Proof":
        with open(path, "rb") as f:
            blob = f.read()
        # header: 5 lines
        idx = 0
        fields = {}
        for _ in range(5):
            nl = blob.index(b"\n", idx)
            line = blob[idx:nl].decode()
            idx = nl + 1
            if line == "PRP PROOF":
                continue
            k, v = line.split("=", 1)
            fields[k] = v
        power = int(fields["POWER"])
        num = fields["NUMBER"]
        parts = num[1:].split("/")
        E = int(parts[0])
        factors = tuple(parts[1:])
        nb = _nbytes(E)
        B = int.from_bytes(blob[idx:idx + nb], "little")
        idx += nb
        middles = []
        for _ in range(power):
            middles.append(int.from_bytes(blob[idx:idx + nb], "little"))
            idx += nb
        return cls(E=E, B=B, middles=middles, known_factors=factors)

    def verify(self, log=print) -> bool:
        """Pietrzak verification (reference Proof.cpp:247-345). The final
        A^(2^span) uses python pow (the span is E/2^power squarings)."""
        E = self.E
        mp = (1 << E) - 1
        A = 3
        B = self.B % mp
        hash_ = _hash_words(E, B)
        span = E
        for M in self.middles:
            hash_ = _hash_words(E, M, prefix=hash_)
            h = _h64(hash_)
            if span % 2:
                B = B * B % mp
            B = mersenne_reduce(gmp.mul(gmp.powmod(M, h, mp), B), E) % mp
            A = mersenne_reduce(gmp.mul(gmp.powmod(A, h, mp), M), E) % mp
            span = (span + 1) // 2
        A = gmp.powmod(A, 1 << span, mp)
        ok = (A % mp) == (B % mp)
        log(f"Verification result: {'SUCCESS' if ok else 'FAIL'}")
        return ok
