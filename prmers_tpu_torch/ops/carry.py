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
    generate/propagate prefix scan (torch has no associative_scan; since
    a digit never both generates and propagates, a running maximum finds
    each digit's last non-propagating one), so a saturated run of
    all-ones digits costs a few launches, not one ripple round per digit;
    the cyclic wrap is closed by feeding the total generate back into
    digit 0.

torch's `>>` on int64 is arithmetic, so the split and the multiply before
the first round work on the 32-bit halves of each value, as the carry
kernels' plain versions do; from the first round on every carry is below
2^63 (below 2^49 for widths of 16 bits and more) and plain int64
arithmetic is exact.

With `rounds` given, the absorb phase runs that many rounds and no loop
that reads the data, so a squaring can be captured in a CUDA graph (the
any-size engine, engine/torch_engine.py); `absorb_rounds` is the bound
that makes every carry 0 or 1 after them. `carry_full_np` is the
reference's numpy path (prmers_tpu/ops/carry.py:24-54, the host oracle
engine/np_engine.py): the split, then single-digit rounds until every
carry is zero.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF


def _prefix_scan(g: torch.Tensor, p: torch.Tensor):
    """Inclusive scan along the last axis of (g, p) under (earlier a,
    later b) -> (g_b | (p_b & g_a), p_b & p_a), for g and p never both set
    (a digit that generates a carry does not propagate one): G[..., j] is g
    at the last position <= j that does not propagate (False if none), and
    P[..., j] is whether every position <= j propagates. The last such
    position is a running maximum, taken within rows of up to 1024 digits
    and then across the rows' last values: torch's cummax along one long
    row runs in a single thread block. Leading axes are independent
    vectors (the lanes of the batched engine)."""
    lead, n = g.shape[:-1], g.shape[-1]
    idx = torch.arange(n, device=g.device)
    last = torch.cummax(torch.where(p, -1, idx).reshape(
        lead + (-1, math.gcd(n, 1024))), -1).values
    if last.shape[-2] > 1:
        rows = torch.cummax(last[..., -1], -1).values
        last[..., 1:, :] = torch.maximum(last[..., 1:, :],
                                         rows[..., :-1, None])
    last = last.reshape(lead + (n,))
    P = last < 0
    G = torch.gather(g, -1, last.clamp(min=0)) & ~P
    return G, P


def absorb_rounds(bound: int, wmin: int) -> int:
    """Absorb rounds (the first included) after which every carry of a
    digit vector whose values times a stay below bound is 0 or 1, for
    digit widths of at least wmin bits: the rule of
    prmers_tpu/ops/ntt.py:197-203. After r rounds a carry is below 1 +
    2^(1 - wmin) + bound / 2^((r + 1) wmin), and bound >> (r wmin) <= 1
    puts the last term below 2^(1 - wmin)."""
    rounds = 1
    while bound >> (rounds * wmin) > 1:
        rounds += 1
    return rounds


def carry_full_np(F, y, widths, masks, a=1):
    """The reference's numpy path (prmers_tpu/ops/carry.py:24-54 with
    lax=None): y (n,) u64 values, widths and masks u64 (masks None: from
    the widths), a small multiplier a < 2^16."""
    xp = F.xp
    if masks is None:
        widths = widths.astype(xp.uint64)
        masks = (xp.uint64(1) << widths) - xp.uint64(1)
    c, d = y >> widths, y & masks
    if not (isinstance(a, int) and a == 1):
        a64 = xp.uint64(a) if isinstance(a, int) else a
        t = d * a64
        c = c * a64 + (t >> widths)
        d = t & masks
    while bool((c != 0).any()):
        t = d + xp.roll(c, 1)
        c, d = t >> widths, t & masks
    return d


def carry_full(y: torch.Tensor, widths: torch.Tensor,
               masks: torch.Tensor | None = None, a: int = 1,
               rounds: int | None = None) -> torch.Tensor:
    """Exact normalization of y (n,) int64 (u64 bit patterns) times a:
    digits d[j] < 2^widths[j] with the value (sum y_j 2^(q_j)) * a mod
    M_p; y (..., n) normalizes each vector along its last axis. a < 2^16, as the reference requires, so every intermediate fits
    64 bits. rounds: the absorb rounds (absorb_rounds of a bound on y * a)
    in place of the loop while any carry exceeds 1."""
    if not 0 < a < (1 << 16):
        raise ValueError(f"carry_full takes a multiplier in [1, 2^16) "
                         f"(got {a})")
    widths = widths.to(torch.int64)
    if masks is None:
        masks = (1 << widths) - 1
    c, d = first_round(y, widths, masks, a)
    return settle(c, d, widths, masks,
                  None if rounds is None else rounds - 1)


def first_round(y: torch.Tensor, widths: torch.Tensor, masks: torch.Tensor,
                a: int = 1):
    """carry_full's split of y times a into digits and out-carries and its
    first absorb round, on the 32-bit halves of each value: (c, d) for
    settle. widths and masks int64."""
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
    lo = d + torch.roll(cl, 1, -1)
    d = lo & masks
    c = (lo >> widths) + (torch.roll(ch, 1, -1) << (32 - widths))
    return c, d


def settle(c: torch.Tensor, d: torch.Tensor, widths: torch.Tensor,
           masks: torch.Tensor, rounds: int | None = None) -> torch.Tensor:
    """The rest of carry_full from digits d < 2^width and each digit's
    out-carry c (not yet moved to the next digit, 0 <= c < 2^63): rounds
    more absorb rounds (None: while any carry exceeds 1), then the
    lookahead. widths and masks int64."""
    def inject(c, d):
        t = d + torch.roll(c, 1, -1)
        return t >> widths, t & masks

    if rounds is None:
        while bool((c > 1).any()):
            c, d = inject(c, d)
    else:
        for _ in range(rounds):
            c, d = inject(c, d)

    s = d + torch.roll(c, 1, -1)       # <= mask + 1
    g = s > masks                      # generates an out-carry
    p = s == masks                     # propagates an in-carry
    G, Pr = _prefix_scan(g, p)
    x0 = G[..., -1:]                   # cyclic fixed point (total G)
    cin = torch.roll(G, 1, -1) | (torch.roll(Pr, 1, -1) & x0)
    cin[..., :1] = x0
    return (s + cin.to(torch.int64)) & masks
