"""Carry propagation over variable-width IBDWT digits, in torch on the
device (counterpart of prmers_tpu/ops/carry.py:24-97).

`carry_full(y, widths, masks, a)` normalizes a digit vector y times a small
multiplier a so every digit is below 2^width, with the carry out of the
last digit wrapping to digit 0 (2^p = 1 mod M_p). y may hold any u64
value as an int64 bit pattern (the canonical-digit hybrid hands it the
r1 inverse's output, up to P - 1 > 2^63). It runs in two phases, as the
reference does:

  * absorb: shift-and-add rounds while any carry exceeds 1; carries shrink
    geometrically, so this takes about 64 / min(width) rounds;
  * lookahead: the remaining 0/1 carries are resolved with a
    generate/propagate prefix scan (written by hand: torch has no
    associative_scan), so a saturated run of all-ones digits costs
    O(log n) steps, not one ripple round per digit; the cyclic wrap is
    closed by feeding the total generate back into digit 0.

torch's `>>` on int64 is arithmetic, so the split and the multiply before
the first round work on the 32-bit halves of each value, as the carry
kernels' plain versions do; from the first round on every carry is below
2^63 (below 2^49 for widths of 16 bits and more) and plain int64
arithmetic is exact.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _prefix_scan(g: torch.Tensor, p: torch.Tensor):
    """Inclusive scan of (g, p) under (earlier a, later b) ->
    (g_b | (p_b & g_a), p_b & p_a): Hillis-Steele, log2(n) steps."""
    n = g.shape[0]
    shift = 1
    while shift < n:
        g_prev = torch.zeros_like(g)
        p_prev = torch.zeros_like(p)
        g_prev[shift:] = g[:-shift]
        p_prev[shift:] = p[:-shift]
        g = g | (p & g_prev)
        p = torch.cat([p[:shift], p[shift:] & p_prev[shift:]])
        shift *= 2
    return g, p


def carry_full(y: torch.Tensor, widths: torch.Tensor,
               masks: torch.Tensor | None = None, a: int = 1) -> torch.Tensor:
    """Exact normalization of y (n,) int64 (u64 bit patterns) times a:
    digits d[j] < 2^widths[j] with the value (sum y_j 2^(q_j)) * a mod
    M_p. a < 2^16, as the reference requires, so every intermediate fits
    64 bits."""
    if not 0 < a < (1 << 16):
        raise ValueError(f"carry_full takes a multiplier in [1, 2^16) "
                         f"(got {a})")
    widths = widths.to(torch.int64)
    if masks is None:
        masks = (1 << widths) - 1
    y0, y1 = y & _M32, (y >> 32) & _M32
    d = y0 & masks
    # c = y >> w as words: cl the low one, ch the high one
    cl = ((y0 >> widths) | (y1 << (32 - widths))) & _M32
    ch = y1 >> widths
    if a != 1:
        t = d * a                          # < 2^(w+16)
        lo = cl * a + (t >> widths)        # < 2^49
        cl = lo & _M32
        ch = ch * a + (lo >> 32)
        d = t & masks
    # the first round, s = d + roll(c): ch * 2^32 >> w is ch << (32 - w)
    lo = d + torch.roll(cl, 1)
    d = lo & masks
    c = (lo >> widths) + (torch.roll(ch, 1) << (32 - widths))

    def inject(c, d):
        t = d + torch.roll(c, 1)
        return t >> widths, t & masks

    while bool((c > 1).any()):
        c, d = inject(c, d)

    s = d + torch.roll(c, 1)           # <= mask + 1
    g = s > masks                      # generates an out-carry
    p = s == masks                     # propagates an in-carry
    G, Pr = _prefix_scan(g, p)
    x0 = G[-1]                         # cyclic fixed point (total G)
    cin = torch.roll(G, 1) | (torch.roll(Pr, 1) & x0)
    cin[0] = x0
    return (s + cin.to(torch.int64)) & masks
