"""Integer instructions of the rep-loop probes, read from the compiled
kernel library.

`rep_slots()` runs `cuobjdump -sass` on probe_reps.cu's code in the built
library (ops/build.library_path), finds each instantiation of
csrc/probe_reps.cu's rep_kernel<OP>, takes the largest loop of its code
(the span from a backward branch's target to the branch: the rep loop),
reads its unroll from the loop itself (the step of the counter that its
closing branch tests) and sorts its instructions by the pipe that runs
them. Hopper's SM has two integer pipes of 64 lanes (CUDA's throughput
table for compute capability 9.0): the FMA pipe runs IMAD in
all its forms (IMAD.WIDE and IMAD.HI two slots each: a 64-bit result),
the ALU pipe the adds, logic, shifts, compares and selects; VIADD goes to
either (counted where it costs least); branches and the uniform datapath
(U*) to neither. The four dispatch units issue 128 instructions a clock.
So a rep takes at least

    max(ALU slots, FMA slots, (ALU + FMA + either) / 2, issued / 2)

clocks of a 64-lane pipe, the loop's counter, compare and branch shared
among its unrolled reps: its "pipe slots". The tools price the rep
probes with it: slots x reps x elements over tools.int_pipe_rate(). That
bound is the issue rate of the compiled loop, not what the function
needs: a loop with more instructions has a higher bound. Beside it stands
PRODUCT_SLOTS, the FMA slots of the products that the field operation
cannot do without, a loose floor of the function (its adds and folds not
counted).

`python -m prmers_tpu_torch.tools.sass` prints one JSON line with the
card's name and power limit and each op's count, its loop and its
opcodes. With `--kernels` it prints instead the instructions of K3's
kernel (k3_p7c.cu's k3_kernel, one entry a shape and a round count) and
of K4 inverse's (k4_axis0.cu's axis_fft_kernel in mode AX_K3A: K3's r1
inverse without its carry) at L1 = 32 and 64 (`kernel_counts`): every
instruction of the function once, NOP left out. Both are straight-line
code but for their branches (the wrap double, x a, sub2, the tile's
place in its unit) and K3's flag wait, so a thread issues at most that
many, fewer where a branch is not taken.
"""

from __future__ import annotations

import functools
import json
import os
import re
import shutil
import subprocess
import sys

# probe_reps.cu's RepOp ids
REP_NAMES = {0: "vpu", 1: "gl_mul", 2: "gl_sqr", 3: "m31_mul",
             4: "m31_sqr", 5: "m61_mul", 6: "m61_sqr"}
# FMA slots a rep of the products each operation cannot do without, on
# 32 x 32-bit IMAD (one slot; IMAD.WIDE, a 64-bit result, two): vpu's
# y * x + 1 one IMAD; a 64 x 64 -> 128 product four IMAD.WIDE (a square
# three), as a gl64 product and each M61 one (halves of 30 and 32 bits
# still take four); an M31 product one IMAD.WIDE. A complex mul at least
# Karatsuba's three products, a complex sqr two ((a + b)(a - b) and ab).
PRODUCT_SLOTS = {"vpu": 1, "gl_mul": 8, "gl_sqr": 6, "m31_mul": 6,
                 "m31_sqr": 4, "m61_mul": 24, "m61_sqr": 16}
WIDE = ("IMAD.WIDE", "IMAD.HI")
FMA = ("IMAD",)
EITHER = ("VIADD",)
NEITHER = ("BRA", "EXIT", "U")

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+|\.L_\d+)\s*:")
_INSN = re.compile(r"/\*([0-9a-fA-F]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?(U?P[T0-9])\s+")
_STEP = re.compile(r"^(?:IADD3|VIADD)\s+(R\d+),\s*(R\d+),\s*"
                   r"(-?0x[0-9a-fA-F]+)\b")
_TARGET = re.compile(r"`\((\.L\w+)\)|\b(0x[0-9a-fA-F]+)\b")


def functions(sass: str) -> dict:
    """{mangled name: [(address, opcode, text, label or None)]}: each
    function's instructions in order (the text with its guard, the opcode
    without), the label placed before one (if any) beside it."""
    out, cur, label = {}, None, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            label = None
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            label = m.group(1)
            continue
        m = _INSN.search(line)
        if m:
            text = m.group(2).strip()
            op = _PRED.sub("", text).split()[0]
            cur.append((int(m.group(1), 16), op, text, label))
            label = None
    return out


def loops(insns: list) -> list:
    """(first, last) indexes of each backward branch's span: the branch's
    target through the branch."""
    at_label = {lab: i for i, (_a, _o, _t, lab) in enumerate(insns) if lab}
    at_addr = {a: i for i, (a, _o, _t, _l) in enumerate(insns)}
    spans = []
    for i, (_a, op, text, _l) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(_PRED.sub("", text).partition(" ")[2])
        if not m:
            continue
        j = at_label.get(m.group(1)) if m.group(1) else \
            at_addr.get(int(m.group(2), 16))
        if j is not None and j <= i:
            spans.append((j, i))
    return spans


def pipe(op: str) -> str:
    """"fma", "alu", "either" or "neither": where an instruction runs."""
    if op.startswith(FMA):
        return "fma"
    if op.startswith(EITHER):
        return "either"
    if op.startswith(NEITHER):
        return "neither"
    return "alu"


def counter_step(insns: list, j: int, i: int) -> int:
    """The loop j..i's unroll: the step of its counter, the register that
    the last compare setting the closing branch's guard tests and that an
    add of an immediate to itself moves (`VIADD R5, R5, 0xfffffffc`: 4).
    Raises where the loop has no such counter."""
    guard = _PRED.match(insns[i][2])
    if not guard:
        raise ValueError("the loop's branch has no guard")
    setp = [t for _a, op, t, _l in insns[j:i] if op.startswith("ISETP")
            and _PRED.sub("", t).split()[1].rstrip(",") == guard.group(1)]
    if not setp:
        raise ValueError(f"no compare sets the loop's {guard.group(1)}")
    tested = set(re.findall(r"\bR\d+\b", setp[-1].split(",", 2)[2]))
    for _a, _op, t, _l in insns[j:i]:
        m = _STEP.match(_PRED.sub("", t))
        if m and m.group(1) == m.group(2) and m.group(1) in tested:
            step = int(m.group(3), 16)
            return abs(step - (1 << 32) if step >= 1 << 31 else step)
    raise ValueError(f"no counter step in the loop (it tests {tested})")


def loop_count(insns: list) -> dict:
    """The largest loop of a function: its unroll (counter_step), its
    pipe slots per rep, each pipe's slots and the instructions issued per
    rep, and the loop's opcodes' counts (NOP left out)."""
    spans = loops(insns)
    if not spans:
        raise ValueError("no loop in the function")
    j, i = max(spans, key=lambda s: s[1] - s[0])
    unroll = counter_step(insns, j, i)
    by_op: dict = {}
    for _a, op, _t, _l in insns[j:i + 1]:
        if op != "NOP":
            by_op[op] = by_op.get(op, 0) + 1
    per = {"alu": 0, "fma": 0, "either": 0, "neither": 0}
    for op, k in by_op.items():
        per[pipe(op)] += k * (2 if op.startswith(WIDE) else 1)
    issued = sum(by_op.values())
    worst = max(per["alu"], per["fma"],
                (per["alu"] + per["fma"] + per["either"]) / 2, issued / 2)
    return {"slots_per_rep": worst / unroll,
            **{f"{k}_per_rep": v / unroll for k, v in per.items()},
            "issued_per_rep": issued / unroll, "unroll": unroll,
            "loops": len(spans), "opcodes": dict(sorted(by_op.items()))}


def rep_counts(sass: str) -> dict:
    """{op name: loop_count} for every rep_kernel<OP> in the listing."""
    out = {}
    for name, insns in functions(sass).items():
        m = re.search(r"rep_kernelILi(\d+)E", name)
        if m and int(m.group(1)) in REP_NAMES:
            out[REP_NAMES[int(m.group(1))]] = loop_count(insns)
    missing = set(REP_NAMES.values()) - set(out)
    if missing:
        raise RuntimeError(f"no rep_kernel in the SASS for {sorted(missing)}")
    return out


def cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand:
            return cand
    raise RuntimeError("cuobjdump not found: the SASS cannot be read")


def library_sass(source: str = "probe_reps") -> str:
    """The SASS of one source's code in the built library: the library
    holds one cubin a source (`cuobjdump -lelf`, "<source>.sm_90a.cubin"),
    extracted (`-xelf`) and disassembled alone, in a second or so where
    the whole library takes half a minute."""
    import tempfile

    from ..ops import build
    build.lib()
    lib = build.library_path()
    elves = subprocess.run([cuobjdump(), "-lelf", lib], capture_output=True,
                           text=True, check=True).stdout
    names = re.findall(rf"\b({re.escape(source)}\.\S*\.cubin)", elves)
    if not names:
        raise RuntimeError(f"no {source} cubin in {lib}: {elves[:400]}")
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([cuobjdump(), "-xelf", names[0], lib], cwd=d,
                       capture_output=True, text=True, check=True)
        return subprocess.run([cuobjdump(), "-sass",
                               os.path.join(d, names[0])],
                              capture_output=True, text=True,
                              check=True).stdout


@functools.lru_cache(maxsize=None)
def library_counts() -> dict:
    """rep_counts of the built library (read once a process)."""
    return rep_counts(library_sass())


def rep_slots() -> dict:
    """{op name: pipe slots per rep} of the built library."""
    return {k: v["slots_per_rep"] for k, v in library_counts().items()}


def kernel_counts() -> dict:
    """{source: {mangled name: {"issued": n, "opcodes": {...}}}}: K3's
    kernels and K4 inverse's (axis_fft_kernel<3, 5 or 6, 0>), each
    instruction once, NOP left out."""
    out = {}
    for source, pat in (("k3_p7c", r"k3_kernel"),
                        ("k4_axis0", r"axis_fft_kernelILi3ELi[56]ELi0E")):
        found = {}
        for name, insns in functions(library_sass(source)).items():
            if not re.search(pat, name):
                continue
            ops: dict = {}
            for _a, op, _t, _l in insns:
                if op != "NOP":
                    ops[op] = ops.get(op, 0) + 1
            found[name] = {"issued": sum(ops.values()),
                           "opcodes": dict(sorted(ops.items()))}
        if not found:
            raise RuntimeError(f"no {pat} in the SASS of {source}")
        out[source] = found
    return out


def main(argv=None) -> int:
    from ..bench import card
    from . import require_card
    argv = sys.argv[1:] if argv is None else argv
    require_card()
    if "--kernels" in argv:
        print(json.dumps({"tool": "sass", "card": card(),
                          "kernels": kernel_counts()}))
        return 0
    print(json.dumps({"tool": "sass", "card": card(),
                      "rep_loops": library_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
