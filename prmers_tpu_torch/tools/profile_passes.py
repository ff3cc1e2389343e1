"""Per-pass times of the four-step transform at a full-width plan, on the
card: the twin of tools/profile_passes.py.

`python -m prmers_tpu_torch.tools.profile_passes <p> [reps]` (default p =
136279841, n = 2^23, (R1, R2, C) = (64, 64, 2048); reps = 10) times

  * the folded passes a block-carry step runs: P1 (K4 forward), the
    C-transform span in mode sqr (kernels.fused_mid: K2 at 2^23) and P7
    (K4 inverse);
  * the JAX's `_forward_r` with a nonzero scalar carry: K4u forward (the
    carry's parts into digits 0 ... k-1, x w, the r1 DFT, x t_r where no
    matrix folds it), then K5u forward (the r2 DFT, x mid); and
    `_inverse_r`: K5u inverse (x mid_inv, the r2 inverse DFT with t_r_inv
    folded or after it), then K4u inverse (the r1 inverse DFT, x iw,
    canon). Each of the four in the matrix form (tr_fwd, g2, tr_inv,
    (L1, True): the int8 limb planes on the tensor cores) and in the
    shift form (the butterflies PRMERS_NO_MXU selects in the reference);
    at L2 = 64 both forms apply on axis 1 too.

Each pass's device ms (CUDA events around each launch, behind a device
sleep) stands beside its bound; then each is held against its plain
version on the same inputs, exact mod P. The bound prices the work
from the u64 tables whatever form runs it (_pass_bound), so the forms
compare; "s8_bytes" gives beside it the bytes of each matrix's int8
tables, which the matrix form reads instead, and "unfolded_s" the host
seconds that built the unfolded view (u64 and int8 tables). The line gives the card's
name and power limit first. The unfolded tables are built for the run
alone (kernels.with_unfolded), so an engine's cached tables do not grow.

`python -m prmers_tpu_torch.tools.profile_passes --r5 [p] [reps]`
(default p = 700000001, n = 5 * 2^23, (64, 320, 2048)) times K5's two r2
passes (P2, P6) at a radix-5 plan in the split form (csrc/r2_split.cuh),
each beside its bound (24 bytes per digit against the split's products)
and held against the dense plain version; then, under "parts", the
split's two cut-down bodies (kernels.r2_split_part: without the
butterfly levels, and the loads and stores alone), which compute no
transform and are held to nothing: what is left of the full pass's time
without them is the levels' and the arithmetic's share. The three bodies
run in turns (full, no-levels, move, move, no-levels, full), each turn
`reps` launches back to back.

`python -m prmers_tpu_torch.tools.profile_passes --cfft [reps]` times
the C-transform's row kernel (csrc/fused_c_row.cuh) as K6 in mode "sqr"
(the forward transform, the square and the inverse in one launch) at C
= 2048 (p = 136279841, (64, 64, 2048)) and C = 8192 (p = 600000001,
(64, 64, 8192)), each beside its bound and held against the dense plain
version; then, under "parts", the kernel's two cut-down bodies
(kernels.fused_c_part: without the 128-point butterflies, and the loads
and stores alone with an add for each product), held to nothing, in
turns as --r5's.

`python -m prmers_tpu_torch.tools.profile_passes --axis [reps]` times
the axis DFTs of csrc/axis_fft.cuh (register-pass shift butterflies):
the r1 passes K1, K3a ("k3", launched as K4 inverse: K3's r1 inverse
with no x a and no carry) and K4 forward with block carries ("k4f") at
n = 2^23 and 2^25, and K5's P2 and P6 (the r2 passes) at n = 2^23, 2^25
and 2^26 (L2 = 128), each beside its bound (axis_bound) and held against
the dense plain version; then, under
"parts", each pass's move-only body (kernels.axis_fft_move: the same
loads, shared-memory exchange and stores with an add for each product,
no butterflies, into a second buffer) beside its bytes bound, held to
nothing: the full pass's time less the move's is the butterflies' and
the products' share. A pass runs in place, as the engine runs it (K1's
buffer drifts from digits to residues over the turns, which changes no
instruction of it); its checked output is one more launch on the
inputs (K1's and K4 forward's buffers drift the same way). The two
bodies run in turns (pass, move, move, pass), each turn `reps` launches
back to back, with no allocation inside a turn.

`python -m prmers_tpu_torch.tools.profile_passes --k9 [reps]` times K9,
the whole-chain kernel (csrc/k9_chain.cuh), at every n = 2^15 ... 2^19 it
takes: ms per squaring over a chain of K9_STEPS = 64 with a = 1, in
place, in the row form the shape's rule picks ("rule") and in each form
forced ("fused", "split"; kernels.square_chain_part); its move-only
body (kernels.square_chain_part "move": the same grid, loads, stores and
grid barriers, an add for each product, no butterflies); its grid
barriers alone ("barriers": six in the fused form, eight in the split,
six at L2 = 1 where its lane phases hold K2a and K2c) and each
phase alone between them (K9_RUNS runs them in turns, then again in
reverse order, each turn `reps` chains back to back). The rule's and the
two forms' entries stand beside k9_bound and are held against the plain
chain of 2 squarings on their input; the others, under "parts", are held
to nothing.

The reference tool is stale (it calls kn._to_ay, _middle and _to_ax,
which are gone); this twin times what the reference still has.
"""

from __future__ import annotations

import json
import math
import sys
import time

from . import (OPS_PER_PRODUCT, PairTimes, Timed, bound, check, device_ms,
               nbytes, require_card, stream_ms)
from ..bench import card
from ..ops import fourstep as tfs

P_DEFAULT = 136279841
P_R5 = 700000001                # n = 5 * 2^23, (64, 320, 2048)
R5_BODIES = ("split", "no-levels", "move")
P_CFFT = (136279841, 600000001)  # C = 2048 and C = 8192
CFFT_BODIES = ("row", "no-slot-levels", "move")
CIN = 0x9E3779B97F4A7C15        # the scalar carry K4u forward injects
# n = 2^23, 2^25 (L1 = L2 = 64) and 2^26 (L2 = 128): the r1 passes (K1,
# K3a, K4 forward) at the first two, P2 and P6 at all three
P_AXIS = (136279841, 600000001, 1000000007)
AXIS_BODIES = ("pass", "move")
K9_STEPS = 64                   # squarings per timed K9 chain
# K9's runs, (part, phases, form): the shape's rule, each row form forced,
# the move-only body, the grid barriers alone and each phase alone between
# them (the last three in the rule's form)
K9_RUNS = {"rule": ("full", None, "rule"), "fused": ("full", None, "fused"),
           "split": ("full", None, "split"),
           "move": ("move", None, "rule"), "barriers": ("full", (), "rule")}
K9_RUNS.update({f"{p} alone": ("full", (p,), "rule") for p in
                ("k1", "k2a", "row", "k2c", "k3a", "k3b")})


def _pass_bound(t, axis: int, kw: dict):
    """One unfolded pass: its products (the matrix's L per digit, or the
    butterflies' log2(L) / 2 shifted reductions, and one per pre and post)
    and its bytes (the register in and out, the tables once)."""
    R1, R2, C = t.shape
    n = R1 * R2 * C
    L = t.shape[axis]
    per = L if kw.get("mats") is not None else math.log2(L) / 2
    per += (kw.get("pre") is not None) + (kw.get("post") is not None)
    moved = 16 * n + nbytes(*(kw.get(k) for k in ("pre", "post", "mats")))
    if kw.get("cin_widths") is not None:
        moved += nbytes(kw["cin_widths"])
    return bound(per * n * OPS_PER_PRODUCT, moved)


# host seconds of each measured plan's unfolded view (the u64 tables and
# their int8 forms), by p
UNFOLDED_S: dict = {}


def s8_bytes(t) -> dict:
    """Bytes of each unfolded matrix's int8 tables (w8 and corr), by
    name."""
    return {k: nbytes(v.w8, v.corr) for k, v in t.unfolded.s8.items()}


def measure(p: int = P_DEFAULT, reps: int = 10):
    """Time every pass at p's plan; returns (the tables with the unfolded
    view, the list of Timed)."""
    import numpy as np
    import torch

    from ..core.plan import cached_plan
    from ..engine.fourstep_engine import get_tables
    from ..ops import gl64 as gl
    from ..ops import kernels as tk
    dev = require_card()
    plan = cached_plan(p)
    t = get_tables(plan, dev)
    t0 = time.perf_counter()
    t = tk.with_unfolded(t)
    UNFOLDED_S[p] = time.perf_counter() - t0
    R1, R2, C = t.shape
    n = R1 * R2 * C
    rng = np.random.default_rng(p)
    wid = plan.widths.astype(np.uint64)
    x = gl.from_numpy_u64(
        rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        & ((np.uint64(1) << wid) - np.uint64(1)), dev).reshape(t.shape)
    z = gl.from_numpy_u64(rng.integers(0, gl.P, size=t.shape,
                                       dtype=np.uint64), dev)
    out = []

    def timed(kernel, what, fn, plain, b, norm=gl.canon64):
        ms, got = device_ms(fn, reps)
        out.append(Timed(kernel, what, ms, b[0], b[1], got, plain, norm))
        return got

    # the folded passes of a block-carry step (K4 as shift butterflies),
    # each into an output made before its timing
    L1, L2 = R1, R2
    outs = [torch.empty_like(z) for _ in range(3)]
    s = timed("k4_axis0", "P1 forward (folded)",
              lambda: tk.axis0_pass(t, x, False, out=outs[0]),
              lambda: tk.axis0_plain(t, x, False), axis_bound(t, "k4f"))
    k2 = tfs.use_r2fold(t.fp) and not tfs.fc_split(t.fp)
    buf = torch.empty_like(s)

    def span():
        # the engine's span in place on a copy of s where K2 does not
        # take it (K5 + K6 (+ K6b) + K5)
        buf.copy_(s)
        return tk.fused_mid(t, buf, "sqr")

    timed("k2_fused_c" if k2 else "k6_fused_c",
          "C-transform sqr (folded)",
          (lambda: tk.fused_c_pass(t, s, "sqr", out=outs[1])) if k2
          else span,
          lambda: tk.fused_c_plain(t, s, "sqr"), span_bound(t))
    timed("k4_axis0", "P7 inverse (folded)",
          lambda: tk.axis0_pass(t, z, True, out=outs[2]),
          lambda: tk.axis0_plain(t, z, True), axis_bound(t, "k3"),
          norm=None)
    # the unfolded r passes, each form on the same inputs: forward_r on the
    # digits x with the carry, inverse_r on the residues z
    shifts = (False, True) if 64 % L1 == 0 and 64 % L2 == 0 else (False,)
    for shift in shifts:
        form = "shift" if shift else "matrix"
        ps = tk.r_passes(t, shift, CIN)
        v = {"k4u_fwd": x, "k5u_inv": z}
        for name, src, dst in (("k4u_fwd", "k4u_fwd", "k5u_fwd"),
                               ("k5u_fwd", "k5u_fwd", None),
                               ("k5u_inv", "k5u_inv", "k4u_inv"),
                               ("k4u_inv", "k4u_inv", None)):
            axis, inverse, kw = ps[name]
            xin = v[src]
            buf = torch.empty_like(xin)   # no allocation in a timed call

            def fn(xin=xin, axis=axis, inverse=inverse, kw=kw, buf=buf):
                return tk.axis_pass(xin, axis, inverse, out=buf, **kw)

            def plain(xin=xin, axis=axis, inverse=inverse, kw=kw):
                return tk.axis_pass_plain(xin, axis, inverse, **kw)

            got = timed("k4u_pass" if axis == 0 else "k5u_pass",
                        f"{name} {form}", fn, plain, _pass_bound(t, axis, kw),
                        norm=None if kw.get("canon") else gl.canon64)
            if dst is not None:
                v[dst] = got
    return t, out


def span_bound(t):
    """The C-transform span in mode "sqr" (K2, or K5 + K6 + K5) at the
    fewest products its function needs: the r2 DFT both ways as shift
    butterflies (log2(L2) / 2 per digit each) or as the radix-5 split
    (fourstep.r2_split_products each, and x t_r_inv), x mf and x mi, the
    factored C-transform both ways (fourstep.c_fft_products) and the
    square; against the register in and out, mf and mi once and the small
    tables the kernels read."""
    R1, R2, C = t.shape
    n = R1 * R2 * C
    r5 = t.dft5_f is not None
    r2 = 2 * tfs.r2_split_products(R2) + 1 if r5 else math.log2(R2)
    per = r2 + 2 + 2 * tfs.c_fft_products(C) + 1
    moved = 16 * n + nbytes(t.mf, t.mi, t.cs_f, t.cs_i)
    if r5:
        moved += nbytes(t.dft5_f, t.dft5_i, t.tw_f, t.tw_i, t.sh_exp,
                        t.t_r_inv)
    return bound(per * n * OPS_PER_PRODUCT, moved)


def row_bound(t, half: str = "both"):
    """The row kernel alone: one half ("fwd": K6 "fwd"; "inv": K6b with
    the square) or both with the square (K6 "sqr"): the factored
    C-transform's products (fourstep.c_fft_products per half) and the
    square, against the register in and out and the scales it reads."""
    R1, R2, C = t.shape
    n = R1 * R2 * C
    halves = 2 if half == "both" else 1
    per = halves * tfs.c_fft_products(C) + (half != "fwd")
    moved = 16 * n + (nbytes(t.cs_f) if half != "inv" else 0) + \
        (nbytes(t.cs_i) if half != "fwd" else 0)
    return bound(per * n * OPS_PER_PRODUCT, moved)


def split_bound(t, which: str):
    """K5 in the split form: the split's products per digit and the
    epilogue's product (and the prologue's in P6), against the register in
    and out and mf or mi once (24 bytes per digit) and the small tables."""
    R1, L2, C = t.shape
    n = R1 * L2 * C
    inv = which == "p6"
    per = tfs.r2_split_products(L2) + (2 if inv else 1)
    moved = 24 * n + nbytes(t.dft5_f, t.tw_f, t.sh_exp)
    if inv:
        moved += nbytes(t.t_r_inv)
    return bound(per * n * OPS_PER_PRODUCT, moved)


def axis_bound(t, which: str, co=None):
    """K1 ("k1"), K3a and K4 inverse ("k3", a = 1), K4 forward ("k4f") or
    K5's "p2" / "p6" at a power-of-two length as csrc/axis_fft.cuh runs
    them, at the fewest products their function needs: log2(L) / 2 per
    digit for the shift butterflies and the scales (K1, K4 forward: x
    k1_cs, x k1_rs; K3a: x k3_rs; P2: x mf; P6: x mi, x t_r_inv), against
    the register in and out and the tables read once (K1 also its carries
    co and spread tables, K4 forward those of the block carries when co
    is given; the r1 passes the wrap residues)."""
    R1, R2, C = t.shape
    n = R1 * R2 * C
    if which == "k1":
        per = 2 + math.log2(R1) / 2
        moved = 16 * n + nbytes(co, t.k1_cs, t.k1_rs, t.wt, t.cum, t.er,
                                t.ec)
    elif which == "k4f":
        per = 2 + math.log2(R1) / 2
        moved = 16 * n + nbytes(t.k1_cs, t.k1_rs, t.er, t.ec)
        if co is not None:
            moved += nbytes(co, t.bwt, t.bcum)
    elif which == "k3":
        per = 1 + math.log2(R1) / 2
        moved = 16 * n + nbytes(t.k3_rs, t.er, t.ec)
    elif which == "p2":
        per = 1 + math.log2(R2) / 2
        moved = 16 * n + nbytes(t.mf)
    elif which == "p6":
        per = 2 + math.log2(R2) / 2
        moved = 16 * n + nbytes(t.mi, t.t_r_inv)
    else:
        raise ValueError(which)
    return bound(per * n * OPS_PER_PRODUCT, moved)


def move_bound(t, which: str):
    """The move-only body's bytes: the register in and out and the table
    words it adds (k1_cs and k1_rs; k3_rs; mf; mi and t_r_inv)."""
    R1, R2, C = t.shape
    tabs = {"k1": (t.k1_cs, t.k1_rs), "k4f": (t.k1_cs, t.k1_rs),
            "k3": (t.k3_rs,), "p2": (t.mf,), "p6": (t.mi, t.t_r_inv)}[which]
    return bound(0, 16 * R1 * R2 * C + nbytes(*tabs))


def measure_axis(reps: int = 10):
    """K1, K3a (as K4 inverse), K4 forward with block carries and K5's P2 /
    P6 in the shift form at n = 2^23, 2^25 (all five) and 2^26 (K5 at L2
    = 128), and their move-only bodies; returns (the
    tables of the last plan, the list of Timed, the parts' rows). Each row
    is the mean of its two turns of `reps` launches back to back."""
    import numpy as np
    import torch

    from ..core.plan import cached_plan
    from ..engine.fourstep_engine import get_tables
    from ..ops import gl64 as gl
    from ..ops import kernels as tk
    dev = require_card()
    entries, parts = [], []
    for p in P_AXIS:
        plan = cached_plan(p)
        t = get_tables(plan, dev)
        R1, R2, C = t.shape
        n = R1 * R2 * C
        at = f"n=2^{n.bit_length() - 1}"
        rng = np.random.default_rng(p)
        wid = plan.widths.astype(np.uint64)
        x = gl.from_numpy_u64(
            rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
            & ((np.uint64(1) << wid) - np.uint64(1)), dev).reshape(t.shape)
        co = torch.from_numpy(rng.integers(0, 1 << 40, size=t.carry_shape,
                                           dtype=np.int64)).to(dev)
        z = gl.from_numpy_u64(rng.integers(0, gl.P, size=t.shape,
                                           dtype=np.uint64), dev)
        bco = torch.from_numpy(rng.integers(
            0, 1 << 40, size=t.block_carry_shape, dtype=np.int64)).to(dev)
        passes = ("p2", "p6") if R2 > 64 else ("k1", "k3", "k4f", "p2",
                                                "p6")
        src = {which: x if which in ("k1", "k4f") else z
               for which in passes}
        bufs = {which: src[which].clone() for which in passes}
        moved = {which: torch.empty_like(x) for which in passes}

        def run(body, which):
            # no allocation here: a cudaMalloc inside the timed run would
            # stall the host while the events count the idle card
            buf = bufs[which]
            if body == "move":
                tk.axis_fft_move(t, src[which], which, out=moved[which])
            elif which == "k1":
                tk.p1_carry_pass(t, buf, co, out=buf)
            elif which in ("k3", "k4f"):
                tk.axis0_pass(t, buf, which == "k3",
                              co=None if which == "k3" else bco, out=buf)
            else:
                tk.axis1_pass(t, buf, which, out=buf)

        runs = {}
        for body in AXIS_BODIES + AXIS_BODIES[::-1]:
            for which in passes:
                runs.setdefault((body, which), []).append(
                    stream_ms(lambda: run(body, which), reps))
        for (body, which), ms in runs.items():
            ms = PairTimes(tuple(ms))
            if body == "move":
                b = move_bound(t, which)
                parts.append({"what": f"{which} {at} move", "ms": ms.median,
                              "bound_ms": b[0], "bound_by": b[1]})
                continue
            # the checked output: one more pass in place on the inputs
            bufs[which].copy_(src[which])
            run(body, which)
            if which == "k1":
                entries.append(Timed(
                    "k1_p1c", f"k1 {at}", ms, *axis_bound(t, "k1", co),
                    bufs[which],
                    lambda t=t, x=x, co=co: tk.p1_carry_plain(t, x, co),
                    gl.canon64))
            elif which == "k3":
                entries.append(Timed(
                    "k4_axis0", f"k3 (K4 inverse) {at}", ms,
                    *axis_bound(t, "k3"), bufs[which],
                    lambda t=t, z=z: tk.axis0_plain(t, z, True)))
            elif which == "k4f":
                entries.append(Timed(
                    "k4_axis0", f"k4f {at}", ms, *axis_bound(t, "k4f", bco),
                    bufs[which],
                    lambda t=t, x=x, bco=bco: tk.axis0_plain(t, x, False,
                                                             co=bco),
                    gl.canon64))
            else:
                entries.append(Timed(
                    "k5_axis1", f"{which} {at}", ms, *axis_bound(t, which),
                    bufs[which],
                    lambda t=t, z=z, which=which: tk.axis1_plain(t, z, which),
                    gl.canon64))
    return t, entries, parts


def measure_r5(p: int = P_R5, reps: int = 10):
    """K5's P2 and P6 at a radix-5 plan in the split form, and its
    cut-down bodies; returns (the tables, the list of Timed, the parts'
    rows). Each row is the mean of its two turns; a turn is `reps`
    launches back to back, as the engine's squarings queue them (a ~1 ms
    launch dwarfs the host's enqueue)."""
    import numpy as np

    from ..core.plan import cached_plan
    from ..engine.fourstep_engine import get_tables
    from ..ops import gl64 as gl
    from ..ops import kernels as tk
    dev = require_card()
    t = get_tables(cached_plan(p), dev)
    if t.dft5_f is None:
        raise ValueError(f"p = {p} plans no radix-5 r2 factor")
    z = gl.from_numpy_u64(np.random.default_rng(p).integers(
        0, gl.P, size=t.shape, dtype=np.uint64), dev)
    outs = {}
    runs = {}
    for body in R5_BODIES + R5_BODIES[::-1]:
        for which in ("p2", "p6"):
            def fn(body=body, which=which):
                outs[body, which] = (
                    tk.axis1_pass(t, z, which) if body == "split"
                    else tk.r2_split_part(t, z, which, body))
            runs.setdefault((body, which), []).append(stream_ms(fn, reps))
    entries, parts = [], []
    for (body, which), ms in runs.items():
        ms = PairTimes(tuple(ms))
        if body == "split":
            entries.append(Timed(
                "k5_axis1", f"{which} split", ms, *split_bound(t, which),
                outs[body, which],
                lambda which=which: tk.axis1_plain(t, z, which), gl.canon64))
        else:
            parts.append({"what": f"{which} {body}", "ms": ms.median})
    return t, entries, parts


def measure_cfft(reps: int = 10):
    """K6 "sqr" at C = 2048 and 8192 and its cut-down bodies; returns
    (the tables of the last plan, the list of Timed, the parts' rows). Each
    row is the mean of its two turns of `reps` launches back to back."""
    import numpy as np

    from ..core.plan import cached_plan
    from ..engine.fourstep_engine import get_tables
    from ..ops import gl64 as gl
    from ..ops import kernels as tk
    dev = require_card()
    entries, parts = [], []
    for p in P_CFFT:
        t = get_tables(cached_plan(p), dev)
        C = t.shape[2]
        z = gl.from_numpy_u64(np.random.default_rng(p).integers(
            0, gl.P, size=t.shape, dtype=np.uint64), dev)
        outs, runs = {}, {}
        for body in CFFT_BODIES + CFFT_BODIES[::-1]:
            def fn(body=body):
                outs[body] = (
                    tk.fused_c_pass(t, z, "sqr", r2fold=False)
                    if body == "row" else tk.fused_c_part(t, z, body))
            runs.setdefault(body, []).append(stream_ms(fn, reps))
        for body, ms in runs.items():
            ms = PairTimes(tuple(ms))
            if body == "row":
                entries.append(Timed(
                    "k6_fused_c", f"sqr C={C}", ms, *row_bound(t),
                    outs[body], lambda t=t, z=z: tk.fused_c_plain(
                        t, z, "sqr", r2fold=False), gl.canon64))
            else:
                parts.append({"what": f"{body} C={C}", "ms": ms.median})
    return t, entries, parts


def k9_bound(t, co, steps: int = K9_STEPS):
    """One squaring of a K9 chain of `steps` at the fewest products its
    function needs (PERF.md section 3: K1 2 + log2(L1)/2, K2a 1 +
    log2(L2)/2, K2c 2 + log2(L2)/2, the C-transform 2 x
    fourstep.c_fft_products(C), the square, K3a 1 + log2(L1)/2), against
    the register, carries, multipliers and the tables K9 reads, read once
    and written once over the chain."""
    from ..ops import kernels as tk
    R1, R2, C = t.shape
    n = R1 * R2 * C
    per = (2 + math.log2(R1) / 2) + (1 + math.log2(R2) / 2) + \
        (2 + math.log2(R2) / 2) + 2 * tfs.c_fft_products(C) + 1 + \
        (1 + math.log2(R1) / 2)
    tabs = nbytes(t.k1_cs, t.k1_rs, t.mf, t.mi, t.t_r_inv, t.cs_f, t.cs_i,
                  t.k3_rs, t.er, t.ec, t.wt, t.cum, t.widths)
    return bound(per * n * OPS_PER_PRODUCT,
                 (16 * n + 2 * nbytes(co) + 8 * tk.CHAIN_K + tabs) / steps)


def measure_k9(reps: int = 3):
    """K9 at n = 2^15 ... 2^19: each of K9_RUNS; returns (the tables of
    the last plan, the list of Timed (the rule's runs), the parts' rows
    (the others)), ms per squaring, each the mean of its two turns."""
    import numpy as np
    import torch

    from ..core.plan import build_plan
    from ..engine.fourstep_engine import get_tables
    from ..ops import kernels as tk
    from ..utils import digits as dg
    dev = require_card()
    ones = tk.chain_multipliers([1] * tk.CHAIN_K, dev)
    entries, parts = [], []
    for logn in range(15, 20):
        n = 1 << logn
        plan = build_plan(int(n * 16.5) | 1, n=n)
        t = get_tables(plan, dev)
        rng = np.random.default_rng(logn)
        v = int.from_bytes(rng.bytes(plan.p // 8 + 1), "little") % \
            ((1 << plan.p) - 1)
        x = torch.from_numpy(dg.int_to_digits(v, plan.widths).astype(
            np.int64)).to(dev).reshape(t.shape)
        co = torch.from_numpy(rng.integers(0, 1 << 40, size=t.carry_shape,
                                           dtype=np.int64)).to(dev)
        bufs = {k: (x.clone(), co.clone()) for k in K9_RUNS}
        runs = {}
        for k in list(K9_RUNS) + list(K9_RUNS)[::-1]:
            part, phases, form = K9_RUNS[k]
            xb, cb = bufs[k]
            runs.setdefault(k, []).append(stream_ms(
                lambda: tk.square_chain_part(
                    t, xb, cb, ones, K9_STEPS, part,
                    tk.K9_PHASES if phases is None else phases, form),
                reps) / K9_STEPS)
        at = f"n=2^{logn}"
        a31 = tk.chain_multipliers([3, 1], dev)
        for k, ms in runs.items():
            ms = PairTimes(tuple(ms))
            if k not in tk.K9_FORMS:
                parts.append({"what": f"{k} {at}", "ms": ms.median})
                continue
            xg, cg = x.clone(), co.clone()
            tk.square_chain_part(t, xg, cg, a31, 2, form=k)
            entries.append(Timed(
                "k9_chain", at if k == "rule" else f"{at} {k}", ms,
                *k9_bound(t, co), torch.cat([xg.reshape(-1),
                                             cg.reshape(-1)]),
                lambda t=t, x=x, co=co: torch.cat([
                    a.reshape(-1) for a in
                    tk.square_chain_plain(t, x, co, [3, 1], 2)])))
    return t, entries, parts


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    flag = argv[0] if argv[:1] in (["--r5"], ["--cfft"], ["--axis"],
                                   ["--k9"]) else ""
    if flag:
        argv = argv[1:]
    if flag in ("--cfft", "--axis", "--k9"):
        p = {"--cfft": P_CFFT[-1], "--axis": P_AXIS[-1],
             "--k9": int((1 << 19) * 16.5) | 1}[flag]
        reps = int(argv[0]) if argv else 10
        t, entries, *parts = {"--cfft": measure_cfft, "--axis": measure_axis,
                              "--k9": measure_k9}[flag](reps)
    else:
        p = int(argv[0]) if argv else (P_R5 if flag else P_DEFAULT)
        reps = int(argv[1]) if len(argv) > 1 else 10
        t, entries, *parts = (measure_r5 if flag else measure)(p, reps)
    check(entries)
    R1, R2, C = t.shape
    print(json.dumps({"tool": " ".join(("profile_passes", flag)).strip(),
                      "card": card(), "p": p,
                      "n": R1 * R2 * C, "shape": [R1, R2, C], "reps": reps,
                      "passes": [e.row() for e in entries],
                      **({"s8_bytes": s8_bytes(t),
                          "unfolded_s": UNFOLDED_S[p]} if not flag else {}),
                      **({"parts": parts[0]} if parts else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
