"""PrimeNet-format result JSON with the reference's security checksum.

Field order and the canonical-string checksum follow the reference
(reference: src/io/JsonBuilder.cpp:300-575): a CRC32 (uppercase hex) over
"exponent;worktype;factors;startfactors;<per-worktype>;fft-length;
errors;program-name;version;;;os;arch;timestamp", emitted as
{"checksum":{"version":1,"checksum":"XXXXXXXX"}}.
"""

from __future__ import annotations

import json
import platform
import time
import zlib

PROGRAM_NAME = "prmers_tpu"
PROGRAM_VERSION = "0.1.0"
PROGRAM_PORT = 8


def _crc32_upper(s: str) -> str:
    return f"{zlib.crc32(s.encode()) & 0xFFFFFFFF:08X}"


def build_result_json(*, exponent: int, worktype: str, status: str,
                      res64: str = "", res2048: str = "",
                      residue_type: int = 1, gerbicz_errors: int = 0,
                      fft_length: int = 0, b1: int = 0, b2: int = 0,
                      factors: tuple[str, ...] = (),
                      known_factors: tuple[str, ...] = (),
                      curves: int = 0, curve_seed: int = 0,
                      edwards: bool = False, torsion: int = 0,
                      sigma: str = "", proof_power: int = 0,
                      proof_md5: str = "", user: str = "",
                      computer: str = "", aid: str = "",
                      timestamp: str | None = None) -> str:
    """One-line PrimeNet result JSON (worktype: PRP-3 | LL | PM1 | ECM)."""
    ts = timestamp or time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime())
    canon_wt = worktype
    out = {"status": status, "exponent": exponent, "worktype": worktype}
    if known_factors:
        out["known-factors"] = list(known_factors)
    if factors:
        out["factors"] = list(factors)
    if worktype in ("PM1", "ECM"):
        out["b1"] = b1
        if b2 > b1:
            out["b2"] = b2
    if worktype in ("PRP-3", "LL"):
        out["res64"] = res64
        if worktype == "PRP-3":
            if res2048:
                out["res2048"] = res2048
            out["residue-type"] = residue_type
        out["errors"] = {"gerbicz": gerbicz_errors}
        out["shift-count"] = 0
    elif worktype == "ECM":
        if curves:
            out["curves"] = curves
        out["curve-type"] = "Edwards" if edwards else "Montgomery"
        out["torsion-subgroup"] = torsion
        if sigma:
            out["sigma"] = sigma
        out["curve-seed"] = curve_seed
        out["errors"] = {"invariant": gerbicz_errors}
    elif worktype == "PM1":
        out["errors"] = {"gerbicz": gerbicz_errors}
    if fft_length:
        out["fft-length"] = fft_length
    if proof_power:
        out["proof"] = {"version": 2, "power": proof_power,
                        "hashsize": 64, "md5": proof_md5}
    out["program"] = {"name": PROGRAM_NAME, "version": PROGRAM_VERSION,
                      "port": PROGRAM_PORT}
    out["os"] = {"os": platform.system().lower(),
                 "architecture": platform.machine()}
    if user:
        out["user"] = user
    if computer:
        out["computer"] = computer
    if aid:
        out["aid"] = aid
    out["timestamp"] = ts

    # canonical checksum string (reference JsonBuilder.cpp:487-565)
    wt_norm = "PRP" if canon_wt in ("PRP-3", "prp-3") else canon_wt
    factor_str = ",".join(factors)
    start_factor_str = ",".join(known_factors)
    canon = f"{exponent};{wt_norm};{factor_str};{start_factor_str};"
    if canon_wt == "PRP-3":
        canon += f"{res64.lower()};{res2048.lower()};0_3_{residue_type};"
    elif canon_wt == "LL":
        canon += f"{res64.lower()};;0;"
    elif canon_wt == "ECM":
        canon += f"{b1};{b2 if b2 > b1 else ''};"
        sig = ("E" if edwards else "") + (sigma or "")
        if torsion:
            sig += f"_TSG{torsion}"
        canon += f"{sig};"
    elif canon_wt == "PM1":
        canon += f"{b1};{b2 if b2 > b1 else ''};;"
    canon += f"{fft_length};"
    if canon_wt == "ECM":
        canon += f"invariant:{gerbicz_errors};"
    else:
        canon += f"gerbicz:{gerbicz_errors};"
    canon += (f"{PROGRAM_NAME};{PROGRAM_VERSION};;;"
              f"{platform.system().lower()};{platform.machine()};{ts}")
    out["checksum"] = {"version": 1, "checksum": _crc32_upper(canon)}
    return json.dumps(out, separators=(",", ":"))
