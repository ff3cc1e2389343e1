"""Carry propagation over variable-width IBDWT digits, in torch on the
device (counterpart of prmers_tpu/ops/carry.py:24-97).

`carry_full(y, widths)` normalizes a digit vector y (int64, 0 <= y < 2^62)
so every digit is below 2^width, with the carry out of the last digit
wrapping to digit 0 (2^p = 1 mod M_p). It runs in two phases, as the
reference does:

  * absorb: shift-and-add rounds while any carry exceeds 1; carries shrink
    geometrically, so this takes about 64 / min(width) rounds;
  * lookahead: the remaining 0/1 carries are resolved with a
    generate/propagate prefix scan (written by hand: torch has no
    associative_scan), so a saturated run of all-ones digits costs
    O(log n) steps, not one ripple round per digit; the cyclic wrap is
    closed by feeding the total generate back into digit 0.

Only the engine's settle and linear ops use it (multiplier 1), and their
inputs are digits plus at most a row carry (< 2^50), so every value is a
non-negative int64 and plain shifts are exact.
"""

from __future__ import annotations

import torch


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
               masks: torch.Tensor | None = None) -> torch.Tensor:
    """Exact normalization of y (n,) int64: digits d[j] < 2^widths[j] with
    the same value mod M_p."""
    widths = widths.to(torch.int64)
    if masks is None:
        masks = (1 << widths) - 1
    c = y >> widths
    d = y & masks

    def inject(c, d):
        t = d + torch.roll(c, 1)
        return t >> widths, t & masks

    c, d = inject(c, d)
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
