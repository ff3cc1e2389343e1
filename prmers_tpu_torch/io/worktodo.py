"""worktodo.txt parsing and result bookkeeping.

Format parity with the reference (reference: include/io/WorktodoParser.hpp:10-38,
src/io/WorktodoParser.cpp:103-330):
  PRP=[AID,]k,b,n,c[,how_far_factored,tests_saved][,known_factors"..."]
  Test=exponent[,how_far_factored[,has_been_pminus1ed]]  (LL)
  DoubleCheck=[AID,]exponent,...
  Pminus1=[AID,]k,b,n,c,B1,B2[,how_far_factored][,B2_start][,"factors"]
  PFactor=[AID,]k,b,n,c,B1,B2[,"factors"]   (same P-1 entry)
  ECM2=[AID,]k,b,n,c,B1,B2,curves[,"factors"]
Only k=1, b=2, c=-1 (Mersenne) entries are accepted.
Processed entries are appended to worktodo_save.txt and removed
(reference removeFirstProcessed).
"""

from __future__ import annotations

import dataclasses
import os
import re


@dataclasses.dataclass
class WorktodoEntry:
    mode: str                   # prp | ll | pm1 | ecm
    exponent: int
    aid: str = ""
    raw_line: str = ""
    known_factors: tuple[str, ...] = ()
    double_check: bool = False
    b1: int = 0
    b2: int = 0
    b2_start: int = 0
    curves: int = 0
    residue_type: int = 1
    sieve_depth: float = 0.0


_AID_RE = re.compile(r"^[0-9A-Fa-f]{32}$")


def _split_fields(rest: str) -> tuple[list[str], tuple[str, ...]]:
    """Split on commas, extracting quoted known-factor lists."""
    factors: list[str] = []

    def grab(m):
        factors.extend(f.strip() for f in m.group(1).split(",") if f.strip())
        return ""

    rest = re.sub(r'"([^"]*)"', grab, rest)
    fields = [f.strip() for f in rest.split(",") if f.strip() != ""]
    return fields, tuple(factors)


def parse_line(line: str) -> WorktodoEntry | None:
    line = line.strip()
    if not line or line.startswith("#") or "=" not in line:
        return None
    key, rest = line.split("=", 1)
    key_up = key.strip().upper()
    fields, factors = _split_fields(rest)
    aid = ""
    if fields and (_AID_RE.match(fields[0]) or fields[0] == "N/A"):
        aid = fields[0] if fields[0] != "N/A" else ""
        fields = fields[1:]

    def as_int(s, default=0):
        try:
            return int(float(s))
        except ValueError:
            return default

    if key_up in ("TEST", "DOUBLECHECK"):
        if not fields:
            return None
        return WorktodoEntry(mode="ll", exponent=as_int(fields[0]), aid=aid,
                             raw_line=line, known_factors=factors,
                             double_check=(key_up == "DOUBLECHECK"))
    if key_up == "PRP":
        # k,b,n,c[,...]
        if len(fields) >= 4:
            k, b, n, c = (as_int(fields[0]), as_int(fields[1]),
                          as_int(fields[2]), as_int(fields[3]))
            if k != 1 or b != 2 or c != -1:
                return None
            return WorktodoEntry(mode="prp", exponent=n, aid=aid,
                                 raw_line=line, known_factors=factors)
        if len(fields) == 1:  # tolerant short form PRP=p
            return WorktodoEntry(mode="prp", exponent=as_int(fields[0]),
                                 aid=aid, raw_line=line,
                                 known_factors=factors)
        return None
    if key_up in ("PMINUS1", "PFACTOR"):
        # PFactor=k,b,n,c,B1,B2[,"factors"] parses to the same P-1 entry
        # (reference: WorktodoParser.cpp:164-203). Canonical PrimeNet
        # PFactor lines instead carry (sieve_depth, has_been_pminus1ed)
        # in those positions — the reference misreads them as bounds and
        # burns the assignment on a trivial B1; detect that shape
        # (tiny second field) and derive wavefront-scale auto bounds.
        if len(fields) < 6:
            return None
        if key_up == "PFACTOR":
            k, b, n, c = (as_int(fields[0]), as_int(fields[1]),
                          as_int(fields[2]), as_int(fields[3]))
            if k != 1 or b != 2 or c != -1:
                return None
            v4, v5 = as_int(fields[4]), as_int(fields[5])
            if v5 <= 1 and v4 < 100:       # (sieve_depth, pminus1ed)
                b1 = max(50000, (n // 300) // 1000 * 1000)
                e = WorktodoEntry(mode="pm1", exponent=n, aid=aid,
                                  raw_line=line, known_factors=factors,
                                  b1=b1, b2=30 * b1)
                e.sieve_depth = float(v4)
                return e
        k, b, n, c = (as_int(fields[0]), as_int(fields[1]),
                      as_int(fields[2]), as_int(fields[3]))
        if k != 1 or b != 2 or c != -1:
            return None
        e = WorktodoEntry(mode="pm1", exponent=n, aid=aid, raw_line=line,
                          known_factors=factors,
                          b1=as_int(fields[4]), b2=as_int(fields[5]))
        if len(fields) >= 7:
            e.sieve_depth = float(fields[6])
        if len(fields) >= 8:
            e.b2_start = as_int(fields[7])
        return e
    if key_up == "ECM2":
        if len(fields) < 7:
            return None
        k, b, n, c = (as_int(fields[0]), as_int(fields[1]),
                      as_int(fields[2]), as_int(fields[3]))
        if k != 1 or b != 2 or c != -1:
            return None
        return WorktodoEntry(mode="ecm", exponent=n, aid=aid, raw_line=line,
                             known_factors=factors, b1=as_int(fields[4]),
                             b2=as_int(fields[5]), curves=as_int(fields[6]))
    return None


class Worktodo:
    def __init__(self, path: str = "worktodo.txt"):
        self.path = path

    def first_entry(self) -> WorktodoEntry | None:
        if not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            for line in f:
                e = parse_line(line)
                if e is not None:
                    return e
        return None

    def remove_first_processed(self) -> bool:
        """Move the first parseable entry to worktodo_save.txt."""
        if not os.path.exists(self.path):
            return False
        with open(self.path) as f:
            lines = f.readlines()
        out = []
        removed = None
        for line in lines:
            if removed is None and parse_line(line) is not None:
                removed = line
                continue
            out.append(line)
        if removed is None:
            return False
        save = os.path.join(os.path.dirname(self.path) or ".",
                            "worktodo_save.txt")
        with open(save, "a") as f:
            f.write(removed if removed.endswith("\n") else removed + "\n")
        with open(self.path, "w") as f:
            f.writelines(out)
        return True

    def append(self, line: str) -> None:
        with open(self.path, "a") as f:
            f.write(line.rstrip("\n") + "\n")

    def has_more(self) -> bool:
        return self.first_entry() is not None


def append_results_txt(path: str, json_line: str) -> None:
    with open(path, "a") as f:
        f.write(json_line.rstrip("\n") + "\n")


def write_individual_json(save_dir: str, p: int, mode: str,
                          json_line: str) -> str:
    out = os.path.join(save_dir, f"{p}_{mode}_result.json")
    with open(out, "w") as f:
        f.write(json_line)
    return out
