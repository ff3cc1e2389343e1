"""Backend validation matrix: run each mode on every backend /
arithmetic combination and compare residues and factors across them.

Counterpart of the JAX package's tools/validation_matrix.py (reference:
tests/run_backend_validation_matrix.sh, README.md:234-249 - profiles x
backends x modes, residue/factor comparison, summary.tsv). The combos are
backend x arith: numpy/gl64 (the host oracle), jax/gl64 (the any-size
engine, engine/torch_engine.py, on the card; ECM batches its curves
there, engine/batch.py), numpy/fft3161 (the second arithmetic's numpy
oracle), and on the card pallas/gl64 (the four-step kernel engine, as the
reference adds that column on a TPU). Fixed seeds, so every backend runs
the same curves. `cases` and `fingerprint` are the reference's, word for
word.

Usage:
    python -m prmers_tpu_torch.tools.validation_matrix [quick|standard] [out.tsv]

The jax and pallas columns run on the card; with PRMERS_PLATFORM=cpu
(the reference's own switch) the three CPU columns run on the CPU and
there is no pallas column. With no card and no PRMERS_PLATFORM=cpu the
matrix stops with an error: it never drops the card's columns on its own.
A column that raises is recorded as ERROR:<type>:<message> and counts as
a mismatch. Port change: the pallas column runs only the cases whose plan
the four-step engine takes (fourstep_engine.covers, n >= 2^15) and says
which it skips; every case of both profiles (n = 8 ... 512) is below
that, so on the card the column runs none of them.

Exit code 0 iff every case agrees across all backends that ran it.
"""

import os
import sys
import tempfile
import time


def cases(profile: str):
    yield "prp", dict(exponent=9941, mode="prp", proof=False)
    yield "llsafe", dict(exponent=521, mode="llsafe")
    yield "pm1_s1", dict(exponent=541, mode="pm1", b1=899)
    yield "ecm_edwards", dict(exponent=37, mode="ecm", b1=20, b2=400,
                              curves=6, curve_seed=5)
    if profile != "quick":
        yield "prp_cofactor", dict(exponent=2699, mode="prp", proof=False,
                                   known_factors=("5399", "307687",
                                                  "1187561",
                                                  "7570504839257",
                                                  "1987104667810711"))
        yield "llsafe2", dict(exponent=607, mode="llsafe2")
        yield "pm1_s2", dict(exponent=367, mode="pm1", b1=11981, b2=38971)
        yield "pm1_lowmem", dict(exponent=367, mode="pm1", b1=11981,
                                 b2=38971, pm1_variant="lowmem")
        yield "ecm_montgomery", dict(exponent=37, mode="ecm", b1=20,
                                     b2=400, curves=6, curve_seed=5,
                                     edwards=False)


def on_cpu() -> bool:
    return os.environ.get("PRMERS_PLATFORM") == "cpu"


def backends():
    combos = [("numpy", "gl64"), ("jax", "gl64"), ("numpy", "fft3161")]
    if on_cpu():
        return combos   # explicit CPU run: no pallas column
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("validation_matrix: no CUDA card; set "
                         "PRMERS_PLATFORM=cpu to run the CPU columns")
    return combos + [("pallas", "gl64")]


def pallas_takes(exponent: int) -> bool:
    """Does the four-step kernel engine (the pallas column) take the
    case's plan?"""
    from ..core.plan import cached_plan
    from ..engine.fourstep_engine import covers
    return covers(cached_plan(exponent))


def fingerprint(r) -> str:
    """The comparable outcome of a run: factor for factoring modes,
    res64/primality for tests."""
    f = getattr(r, "factor", 0)
    if f:
        return f"factor={f}"
    parts = []
    for attr in ("is_prime", "cofactor_prp", "res64"):
        v = getattr(r, attr, None)
        if v not in (None, ""):
            parts.append(f"{attr}={v}")
    return ",".join(parts) or "no-result"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    profile = argv[0] if len(argv) > 0 else "quick"
    out_path = argv[1] if len(argv) > 1 else ""
    from ..app import run
    from ..io.options import Options

    device = "cpu" if on_cpu() else None
    combos = backends()
    rows = []
    bad = 0
    for name, kw in cases(profile):
        seen = {}
        for backend, arith in combos:
            if arith == "fft3161" and name.startswith("ecm"):
                continue   # same engines, slow; gl64 covers the mode
            if backend == "pallas" and not pallas_takes(kw["exponent"]):
                print(f"{name:16s} {backend}/{arith:10s} skipped: the "
                      "four-step engine does not take the plan")
                continue
            with tempfile.TemporaryDirectory() as td:
                o = Options(backend=backend, arith=arith, save_dir=td,
                            worktodo_path=os.path.join(td, "wt.txt"),
                            results_path=os.path.join(td, "r.txt"), **kw)
                t0 = time.perf_counter()
                try:
                    r, _ = run(o, device=device, log=lambda *a, **k: None)
                    fp = fingerprint(r)
                except Exception as e:   # noqa: BLE001 — recorded, not fatal
                    fp = f"ERROR:{type(e).__name__}:{e}"
                dt = time.perf_counter() - t0
            seen.setdefault(fp, []).append(f"{backend}/{arith}")
            rows.append((name, f"{backend}/{arith}", fp, f"{dt:.1f}"))
            print(f"{name:16s} {backend}/{arith:10s} {dt:7.1f}s  {fp}")
        if len(seen) != 1:
            bad += 1
            print(f"MISMATCH in {name}: {seen}", file=sys.stderr)
    if out_path:
        with open(out_path, "w") as f:
            f.write("case\tbackend\toutcome\tseconds\n")
            for row in rows:
                f.write("\t".join(row) + "\n")
        print(f"summary written to {out_path}")
    print(f"{'OK' if not bad else 'FAIL'}: {len(rows)} runs, "
          f"{bad} mismatched cases")
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
