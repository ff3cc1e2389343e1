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
    (L1, True)) and in the shift form (the butterflies PRMERS_NO_MXU
    selects in the reference); at L2 = 64 both forms apply on axis 1 too.

Each pass's device ms (CUDA events around each launch, behind a device
sleep) stands beside its bound; then each is held against its plain
version on the same inputs, exact mod P. The line gives the card's name
and power limit first. The unfolded tables are built for the run alone
(kernels.with_unfolded), so an engine's cached tables do not grow.

The reference tool is stale (it calls kn._to_ay, _middle and _to_ax,
which are gone); this twin times what the reference still has.
"""

from __future__ import annotations

import json
import math
import sys

from . import (OPS_PER_PRODUCT, Timed, bound, check, device_ms, nbytes,
               require_card)
from ..bench import card

P_DEFAULT = 136279841
CIN = 0x9E3779B97F4A7C15        # the scalar carry K4u forward injects


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


def measure(p: int = P_DEFAULT, reps: int = 10):
    """Time every pass at p's plan; returns (the tables with the unfolded
    view, the list of Timed)."""
    import numpy as np
    import torch

    from ..core.plan import cached_plan
    from ..engine.fourstep_engine import get_tables
    from ..ops import fourstep as tfs
    from ..ops import gl64 as gl
    from ..ops import kernels as tk
    dev = require_card()
    plan = cached_plan(p)
    t = tk.with_unfolded(get_tables(plan, dev))
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

    # the folded passes of a block-carry step
    L1, L2, ca = R1, R2, C // 128
    tabs = nbytes(t.k1_mats, t.er, t.ec)
    s = timed("k4_axis0", "P1 forward (folded)",
              lambda: tk.axis0_pass(t, x, False),
              lambda: tk.axis0_plain(t, x, False),
              bound(L1 * n * OPS_PER_PRODUCT, 16 * n + tabs))
    k2 = tfs.use_r2fold(t.fp) and not tfs.fc_split(t.fp)
    buf = torch.empty_like(s)

    def span():
        # the engine's span in place on a copy of s where K2 does not
        # take it (K5 + K6 (+ K6b) + K5)
        buf.copy_(s)
        return tk.fused_mid(t, buf, "sqr")

    timed("k2_fused_c" if k2 else "k6_fused_c",
          "C-transform sqr (folded)",
          (lambda: tk.fused_c_pass(t, s, "sqr")) if k2 else span,
          lambda: tk.fused_c_plain(t, s, "sqr"),
          bound((2 * L2 + 2 * ca + 2 * 128 + 3) * n * OPS_PER_PRODUCT,
                16 * n + nbytes(t.g2, t.mf, t.lane_f, t.lane_i, t.Mf,
                                 t.Mi, t.mi, t.tri)))
    timed("k4_axis0", "P7 inverse (folded)",
          lambda: tk.axis0_pass(t, z, True),
          lambda: tk.axis0_plain(t, z, True),
          bound(L1 * n * OPS_PER_PRODUCT, 16 * n + nbytes(t.k3_mats, t.er,
                                                          t.ec)), norm=None)
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

            def fn(xin=xin, axis=axis, inverse=inverse, kw=kw):
                return tk.axis_pass(xin, axis, inverse, **kw)

            def plain(xin=xin, axis=axis, inverse=inverse, kw=kw):
                return tk.axis_pass_plain(xin, axis, inverse, **kw)

            got = timed("k4u_pass" if axis == 0 else "k5u_pass",
                        f"{name} {form}", fn, plain, _pass_bound(t, axis, kw),
                        norm=None if kw.get("canon") else gl.canon64)
            if dst is not None:
                v[dst] = got
    return t, out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = int(argv[0]) if argv else P_DEFAULT
    reps = int(argv[1]) if len(argv) > 1 else 10
    t, entries = measure(p, reps)
    check(entries)
    R1, R2, C = t.shape
    print(json.dumps({"tool": "profile_passes", "card": card(), "p": p,
                      "n": R1 * R2 * C, "shape": [R1, R2, C], "reps": reps,
                      "passes": [e.row() for e in entries]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
