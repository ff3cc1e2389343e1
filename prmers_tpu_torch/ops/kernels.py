"""The kernels of one squaring: wrappers, plain versions, counters.

Counterpart of prmers_tpu/ops/pallas/kernels.py (:265-375, :474-916,
:1164-1308, :1315-1743). A register is one int64 tensor (R1, R2, C)
holding u64 bit patterns (digits, or lazy values mod P between kernels).
The carry state depends on the pipeline (fourstep.Pipeline):
  * row carry (the default): one int64 tensor (R1, R2, T), the out-carry
    of each carry unit of ct = C / T consecutive digits (T = 1: a whole
    row), NOT yet rolled (the JAX keeps (R1, R2, T*128) u32 pairs with the
    value in lane t*128; convert.py maps between them);
  * block carry (rowcarry=False): one int64 tensor (R1, 1), the
    out-carry of each r1 block of R2*C digits, not yet rolled (the JAX's
    (R1, 1) pairs);
  * the canonical-digit hybrid (xla_carry=True): (R1, 1) zeros that pass
    through, since carry_full leaves no carry pending.

Each wrapper takes its plain torch version for a CPU tensor, and launches
its CUDA kernel (csrc/, ops/build.py) for a CUDA tensor; there is no other
branch. `calls` counts, per kernel, the wrapper calls that launched it: one
per call, however many grid launches the kernel takes (K2 three, two in
mode "fwd"; the others one).

  K1  p1_carry_pass         csrc/k1_p1c.cu      carry inject, wrap halve,
                            (axis_fft.cuh)      r1 DFT
  K2  fused_c_pass          csrc/k2_fused_c.cu  r2 DFT x mf, C-transform
      (r2fold)                                  with the mode, mirror
  K3  p7_carry_pass         csrc/k3_p7c.cu      r1 inverse DFT, double,
                            (axis_fft.cuh,      canon, x a or + (M_p - 2),
                            k3_tile.cuh)        carry per unit, in one
                                                launch (edge words between
                                                tiles in DevTables.k3_scratch)
  K5  axis1_pass            csrc/k5_axis1.cu    P2 (r2 DFT x mf) or P6
                            (axis_fft.cuh)      (x mi, r2 inverse) alone
  K6  fused_c_pass          csrc/k6_fused_c.cu  the C-transform with the
      (r2fold off)                              mode, no r2 passes
  K6b fused_c_invh_pass     csrc/k6_fused_c.cu  head op, inverse half of
                                                the C-transform
  K9  square_chain          csrc/k9_chain.cuh   up to CHAIN_K squarings
                            (axis_fft.cuh,      x^2 * a_k in one persistent
                            fused_c_row.cuh)    launch (n = 2^15 ... 2^19)
  K4  axis0_pass            csrc/k4_axis0.cu    forward: block-carry inject,
                            (axis_fft.cuh)      wrap halve, r1 DFT; inverse:
                                                r1 inverse, double, canon
  K7  block_carry_pass      csrc/k7_block_carry.cu  x a, the carry ripple
                                                over each r1 block, block
                                                out-carries
  K8  block_carry_local     csrc/k7_block_carry.cu  K7's kernel with K8's
                                                round rule, on a rank's
                                                r1 blocks (the mesh)
  K4u axis_pass, axis 0     csrc/k4u_pass.cu    the unfolded r passes:
  K5u axis_pass, axis 1     (s8_mma.cuh,        [halve], [inject], [x pre],
                            s8_dft.cuh,         DFT (matrix: int8 limb
                            axis_fft.cuh)       planes on the tensor cores;
                                                or shift butterflies),
                                                [x post], [double, canon]
  K10 f3_fwd_stage          csrc/f3_ntt.cu      the second arithmetic
                            (f3_ntt.cuh)        (fft3161): one DIF stage
                                                of both planes [the first
                                                with norm(d) x weights]
  K11 f3_inv_stage          csrc/f3_ntt.cu      one DIT stage [the last
                                                with x unweights, the CRT
                                                to (lo, hi)]
  K12 f3_pointwise          csrc/f3_ntt.cu      the spectrum squared, or
                                                times a multiplicand

A row-carry step runs K1, the C-transform span `fused_mid` and K3;
`fused_mid` picks K2, or K5 + K6 + K5, or K5 + K6 "fwd" + K6b + K5, exactly
as the JAX `_fused_mid` (:1597) does. A block-carry step runs K4, the same
span, K4 inverse and K7; the hybrid the same with carry_full in place of
K7. All but K7 may run in place (out is x): each CUDA block reads the
elements it writes before writing them. Where the JAX package takes its
whole-chain kernel (fourstep.chain_ok), a chain of squarings is one K9
launch that runs the row-carry stages as its phases. No step runs K4u or
K5u: they are the JAX's `_forward_r` / `_inverse_r` (forward_r,
inverse_r below, on DevTables' optional `unfolded` view), which only the
pass profiler (tools/profile_passes.py) and the tests reach, as in the
reference. Their plain version multiplies by the u64 matrix; the CUDA
matrix form takes the same matrix as the reference's int8 limb planes
(ops/mxu_tables.py; S8Tables, built with the view), and s8_dft_model
below is its torch model, for the tests.

The plain versions of K1, K3's first half, K4 and K2's and K5's r2
stages multiply by the dense folded matrices (k1_mats, k3_mats, g2,
tri). Their CUDA launches run csrc/axis_fft.cuh's register-pass shift
butterflies on the factored tables instead (k1_cs, k1_rs; k3_rs; mf, mi;
t_r_inv): one or two products per digit, equal mod P (K3's and K4
inverse's canonical outputs bit for bit); axis_fft_model,
p1_carry_model, axis1_model, p7_dft_model and axis0_model below are its
torch model, for the tests. K9 runs the same bodies as its phases (K1,
K2a, the row C-transform of csrc/fused_c_row.cuh, K2c, K3a, K3b) on the
same factored tables; square_chain_model is its torch model.

The radix-5 plans (n = 5 * 2^k, R2 = L2 = 5 * 2^b up to 320) go through
the same wrappers: no wrapper, plain version or kernel other than the r2
DFT needs a power-of-two R2. K1, K3 and K4 take R2 as the grid's r2
extent, K3's carry, K7 and the row kernel count rows or units of it.
The plain r2 DFT multiplies by the natural-order matrices g2 and tri
(ops/fourstep.dft_matrix), the JAX's; the CUDA r2 launches (K2a/K2c, K5)
run csrc/r2_split.cuh's 5 x 2^b split on the split tables instead
(fourstep.r2_split_tables; r2_split_plain below is its torch model, for
the tests). K9 never runs there (fourstep.chain_ok asks for a
power-of-two L2, as the JAX does).

K10-K12 are engine/engine3161.py's: a squaring is the forward stages,
K12, the inverse stages and ntt2.carry (torch ops). They take the
ntt2.DevTables3161 of a plan and the (2, n) planes (M31 int32, M61 int64),
in place, and their plain versions are ntt2.fwd_stage_plain,
inv_stage_plain and pointwise_plain. The JAX package has no Pallas kernel
there (its fft3161 path is XLA ops), so they replace no pallas_call: each
stands for a function of prmers_tpu/ops/ntt2.py (REPLACES).

On the mesh (parallel/sharded_kernels.py) every wrapper runs on a rank's
shard view of the tables (DevTables.from_host with R2_VIEW: K1, K3, K4 on
(R1, R2/s, C); with R1_VIEW: K5, K6, K6b, K8 on (R1/s, R2, C)), whose
shape is the shard's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build
from . import carry as carry_ops
from . import fourstep as tfs
from . import gl64 as gl
from . import mxu_tables as mxt
from . import ntt2

KERNELS = ("k1_p1c", "k2_fused_c", "k3_p7c", "k5_axis1", "k6_fused_c",
           "k6b_fused_c_invh", "k9_chain", "k4_axis0", "k7_block_carry",
           "k8_local", "k4u_pass", "k5u_pass", "f3_fwd_stage",
           "f3_inv_stage", "f3_pointwise")
SOURCES = {
    # K1 and K5 at a power-of-two length: the shift butterflies' header
    # (k1_p1c.cu and k5_axis1.cu are their entry points)
    "k1_p1c": "prmers_tpu_torch/csrc/axis_fft.cuh",
    # K2, K6 and K6b: the row kernel's header, which runs K6, K6b and K2's
    # row launch (the larger part of K2; k2_fused_c.cu adds its two r2
    # launches, axis_fft.cuh's at a power-of-two L2 and r2_split.cuh's at
    # a radix-5 one, and k6_fused_c.cu the K6 entry points)
    "k2_fused_c": "prmers_tpu_torch/csrc/fused_c_row.cuh",
    # K3: one launch, the r1 inverse of axis_fft.cuh and the tiled row
    # carry of k3_tile.cuh
    "k3_p7c": "prmers_tpu_torch/csrc/k3_p7c.cu",
    "k5_axis1": "prmers_tpu_torch/csrc/axis_fft.cuh",
    "k6_fused_c": "prmers_tpu_torch/csrc/fused_c_row.cuh",
    "k6b_fused_c_invh": "prmers_tpu_torch/csrc/fused_c_row.cuh",
    # K9: the kernel's header (k9_chain.cu is the engine's entry point)
    "k9_chain": "prmers_tpu_torch/csrc/k9_chain.cuh",
    # K4: both launches are the shift butterflies' (k4_axis0.cu the entry)
    "k4_axis0": "prmers_tpu_torch/csrc/axis_fft.cuh",
    "k7_block_carry": "prmers_tpu_torch/csrc/k7_block_carry.cu",
    "k8_local": "prmers_tpu_torch/csrc/k7_block_carry.cu",
    "k4u_pass": "prmers_tpu_torch/csrc/k4u_pass.cu",
    "k5u_pass": "prmers_tpu_torch/csrc/k4u_pass.cu",
    "k2_fused_c[r5]": "prmers_tpu_torch/csrc/fused_c_row.cuh",
    # at a radix-5 L2 the split's header runs all of K5's launches
    "k5_axis1[r5]": "prmers_tpu_torch/csrc/r2_split.cuh",
    # K10-K12: the bodies are f3_ntt.cuh's, f3_ntt.cu the launches
    "f3_fwd_stage": "prmers_tpu_torch/csrc/f3_ntt.cu",
    "f3_inv_stage": "prmers_tpu_torch/csrc/f3_ntt.cu",
    "f3_pointwise": "prmers_tpu_torch/csrc/f3_ntt.cu",
}
REPLACES = {
    "k1_p1c": "prmers_tpu/ops/pallas/kernels.py:512",
    "k2_fused_c": "prmers_tpu/ops/pallas/kernels.py:991",
    "k3_p7c": "prmers_tpu/ops/pallas/kernels.py:612",
    "k5_axis1": "prmers_tpu/ops/pallas/kernels.py:130",
    "k6_fused_c": "prmers_tpu/ops/pallas/kernels.py:991",
    "k6b_fused_c_invh": "prmers_tpu/ops/pallas/kernels.py:1117",
    "k9_chain": "prmers_tpu/ops/pallas/kernels.py:1755",
    # _pass_kernel in its axis-0 form, launched by _axis0_pass (:268)
    "k4_axis0": "prmers_tpu/ops/pallas/kernels.py:130",
    "k7_block_carry": "prmers_tpu/ops/pallas/kernels.py:1315",
    "k8_local": "prmers_tpu/parallel/sharded_pallas.py:201",
    # _pass_kernel's unfolded forms, through _axis0_pass's pallas_call
    # (:365) and _axis1_pass's (:452)
    "k4u_pass": "prmers_tpu/ops/pallas/kernels.py:365",
    "k5u_pass": "prmers_tpu/ops/pallas/kernels.py:452",
    # no pallas_call: the XLA functions of the fft3161 path they stand for
    # (plane_fwd and forward_3161; plane_inv and inverse_3161; Fq2Ops.sqr
    # and mul on the spectrum)
    "f3_fwd_stage": "prmers_tpu/ops/ntt2.py:264",
    "f3_inv_stage": "prmers_tpu/ops/ntt2.py:291",
    "f3_pointwise": "prmers_tpu/core/field2.py:243",
}
calls = {name: 0 for name in KERNELS}

MODES = {"sqr": 0, "mul": 1, "fwd": 2}
CHAIN_K = 512           # K9's multiplier-buffer extent (kernels.py:1916)
HEAD_OPS = {"": 0, "sqr": 1, "mul": 2}


def reset_calls() -> None:
    for name in KERNELS:
        calls[name] = 0


_U64_TABLES = ("k1_mats", "k1_cs", "k1_rs", "g2", "mf", "mi", "lane_f",
               "lane_i", "Mf", "Mi", "cs_f", "cs_i", "tri", "k3_mats",
               "k3_rs", "dft5_f", "dft5_i", "tw_f", "tw_i", "t_r_inv")
_I32_TABLES = ("er", "ec", "wt", "cum", "widths", "bwt", "bcum", "sh_exp")

# The shard views of the mesh (sharded_pallas.py:92-136): each table a view
# keeps, with the axis cut to the rank's part (None: kept whole). Tables a
# view leaves out are None in it, so a kernel given the wrong view fails.
# The r2-sharded view serves K1, K3 and K4 on (R1, R2/s, C); the
# r1-sharded one K5, K6, K6b and K8 on (R1/s, R2, C). Every r2 DFT runs on
# the r1-sharded view with the whole of L2, so at a radix-5 L2 that view
# keeps the split's tables whole (dft5_f/i, tw_f/i, sh_exp; t_r_inv is cut
# by rows as at any L2); None at a power-of-two L2, as on one card. The
# r2-sharded view has no table with an r2 DFT in it: K1, K3 and K4 take
# R2/s as an extent and cut every (R1, R2) or per-r2 table on its r2 axis.
R2_VIEW = {"k1_mats": 0, "k1_cs": 1, "k1_rs": 1, "k3_mats": 0, "k3_rs": 1,
           "er": 1, "ec": None, "wt": 1, "cum": 1, "widths": 1}
R1_VIEW = {"g2": None, "mf": 0, "mi": 0, "lane_f": None, "lane_i": None,
           "Mf": None, "Mi": None, "cs_f": None, "cs_i": None, "tri": 0,
           "t_r_inv": 0, "dft5_f": None, "dft5_i": None, "tw_f": None,
           "tw_i": None, "sh_exp": None, "ec": None, "widths": 0, "bwt": 0,
           "bcum": 0}


@dataclasses.dataclass(eq=False)
class DevTables:
    """The kernel tables on one device: u64 matrices and mids as int64 bit
    patterns, residues and widths as int32. The shape of the register the
    kernels take is that of the widths."""
    fp: object
    k1_mats: torch.Tensor | None
    g2: torch.Tensor | None
    mf: torch.Tensor | None
    mi: torch.Tensor | None
    lane_f: torch.Tensor | None
    lane_i: torch.Tensor | None
    Mf: torch.Tensor | None
    Mi: torch.Tensor | None
    cs_f: torch.Tensor | None
    cs_i: torch.Tensor | None
    tri: torch.Tensor | None
    k3_mats: torch.Tensor | None
    er: torch.Tensor | None
    ec: torch.Tensor | None
    wt: torch.Tensor | None
    cum: torch.Tensor | None
    widths: torch.Tensor
    k: int
    ct: int
    rounds: int
    bwt: torch.Tensor | None
    bcum: torch.Tensor | None
    bk: int
    k8_rounds: int
    dft5_f: torch.Tensor | None = None
    dft5_i: torch.Tensor | None = None
    tw_f: torch.Tensor | None = None
    tw_i: torch.Tensor | None = None
    sh_exp: torch.Tensor | None = None
    t_r_inv: torch.Tensor | None = None
    k1_cs: torch.Tensor | None = None
    k1_rs: torch.Tensor | None = None
    k3_rs: torch.Tensor | None = None
    unfolded: "UnfoldedView | None" = None
    # K3's scratch (csrc/k3_p7c.cu: its ticket, epoch, flags and edge
    # words), zeros, made once with the tables that K3 reads; the kernel
    # keeps it ready for its next launch, so no call resets it
    k3_scratch: torch.Tensor | None = None

    @classmethod
    def from_host(cls, kt: tfs.KernelTables, device, view: dict | None = None,
                  rank: int = 0, s: int = 1) -> "DevTables":
        """The tables on device; with a view (R2_VIEW, R1_VIEW), rank's
        shard of them for s ranks, each cut table one contiguous copy."""
        tabs = {}
        for name in _U64_TABLES + _I32_TABLES:
            a = getattr(kt, name)
            if a is None:
                tabs[name] = None
                continue
            if view is not None:
                if name not in view:
                    tabs[name] = None
                    continue
                ax = view[name]
                if ax is not None:
                    m = a.shape[ax] // s
                    a = np.ascontiguousarray(
                        np.take(a, np.arange(rank * m, (rank + 1) * m), ax))
            tabs[name] = (gl.from_numpy_u64(a, device) if name in _U64_TABLES
                          else torch.from_numpy(a.astype("int32")).to(device))
        if tabs["k3_rs"] is not None:
            words = k3_scratch_words(tuple(tabs["widths"].shape), kt.rounds)
            tabs["k3_scratch"] = torch.zeros(words, dtype=torch.int64,
                                             device=device)
        return cls(fp=kt.fp, k=kt.k, ct=kt.ct, rounds=kt.rounds, bk=kt.bk,
                   k8_rounds=kt.k8_rounds, **tabs)

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.widths.shape)

    @property
    def row_carry_shape(self) -> tuple[int, int, int]:
        """The carries K1, K3 and K9 take and give: one per carry unit."""
        R1, R2, C = self.shape
        return (R1, R2, C // self.ct)

    @property
    def block_carry_shape(self) -> tuple[int, int]:
        """The carries K4 takes and K7 gives: one per r1 block."""
        return (self.shape[0], 1)

    @property
    def carry_shape(self) -> tuple:
        """The carry state of the plan's pipeline."""
        return (self.row_carry_shape if tfs.use_rowcarry(self.fp)
                else self.block_carry_shape)

    @property
    def device(self) -> torch.device:
        return self.widths.device


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _check(t: DevTables, regs=(), carries=(), block: bool = False) -> None:
    """Registers must be (R1, R2, C) and carries (R1, R2, T), or (R1, 1)
    with block, all contiguous int64 on the tables' device: the kernels
    index them from the shape."""
    cshape = t.block_carry_shape if block else t.row_carry_shape
    for shape, tensors in ((t.shape, regs), (cshape, carries)):
        for x in tensors:
            if x is None:
                continue
            if x.dtype != torch.int64 or not x.is_contiguous() or \
                    x.device != t.device or tuple(x.shape) != shape:
                raise ValueError(
                    f"kernel operand must be contiguous int64 {shape} on "
                    f"{t.device} (got {x.dtype} {tuple(x.shape)} on "
                    f"{x.device})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _wrap_mask(t: DevTables) -> torch.Tensor:
    """(R1, R2, C) bool: er + ec >= n (the weight's root-of-2 wrap)."""
    R1, R2, C = t.shape
    er = t.er.to(torch.int64).reshape(R1, R2, 1)
    ec = t.ec.to(torch.int64).reshape(1, 1, C)
    return (er + ec) >= t.fp.n


def _units(t: DevTables, x: torch.Tensor) -> torch.Tensor:
    """(R1, R2, C) -> (R1, R2, T, ct): one carry unit per last-axis run."""
    return x.reshape(t.row_carry_shape + (t.ct,))


def roll_row_carries(co: torch.Tensor) -> torch.Tensor:
    """Roll the unit carries by one flat carry unit: unit u receives unit
    u-1's carry, unit 0 the last unit's (the mod-M_p fold); kernels.py:889."""
    return torch.roll(co.reshape(-1), 1).reshape(co.shape)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def inject_parts(cin: torch.Tensor, wt: torch.Tensor,
                 cum: torch.Tensor) -> torch.Tensor:
    """Each unit's incoming carry (already rolled) spread base-2^width over
    its first k digits, the widths wt and bit offsets cum (..., k): parts
    < 2^32, the last one the unmasked low word of what is left
    (kernels.py:474, and :1505-1527 for the r1 blocks)."""
    c0, c1 = gl.split(cin.unsqueeze(-1))
    cm = cum.to(torch.int64)
    w = wt.to(torch.int64)
    lo_sh = torch.clamp(cm, max=31)
    hi_sh = torch.clamp(cm - 32, min=0, max=31)
    lo_part = ((c0 >> lo_sh) | (c1 << (32 - lo_sh))) & gl.M32
    part = torch.where(cm < 32, lo_part, c1 >> hi_sh)
    part = torch.where(cm >= 64, 0, part)
    masked = part & ((1 << w) - 1)
    last = torch.zeros_like(part, dtype=torch.bool)
    last[..., -1] = True
    return torch.where(last, part, masked)


def _p1_inject(t: DevTables, x: torch.Tensor,
               co: torch.Tensor) -> torch.Tensor:
    """K1's injection: the rolled unit carries' parts added to each unit's
    first k digits."""
    k = t.k
    parts = inject_parts(roll_row_carries(co), t.wt, t.cum)
    xu = _units(t, x)
    head = xu[..., :k] + parts           # digits < 2^32: no u64 wrap
    return torch.cat([head, xu[..., k:]], dim=-1).reshape(t.shape)


def p1_carry_plain(t: DevTables, x: torch.Tensor,
                   co: torch.Tensor) -> torch.Tensor:
    """Plain K1: inject the rolled unit carries, halve where wrapped, then
    the per-r2 folded r1 DFT."""
    return _p1_dft(t, _p1_inject(t, x, co))


def _p1_dft(t: DevTables, y: torch.Tensor) -> torch.Tensor:
    """Halve where wrapped, then the per-r2 folded r1 DFT: the plain K1
    and K4 forward after their injections."""
    y = gl.join(*gl.halve_where(*gl.split(y), _wrap_mask(t)))
    # out[k1, r2, c] = sum_j k1_mats[r2][k1][j] * y[j, r2, c]
    out = gl.matmul_mod(t.k1_mats, y.permute(1, 0, 2))
    return out.permute(1, 0, 2).contiguous()


def p1_carry_pass(t: DevTables, x: torch.Tensor, co: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """K1 on register x with the previous step's (unrolled) carries co."""
    _check(t, (x, out), (co,))
    if _on_cpu(x):
        r = p1_carry_plain(t, x, co)
        return r if out is None else out.copy_(r)
    R1, R2, C = t.shape
    if out is None:
        out = torch.empty_like(x)
    err = build.lib().prmers_k1_p1c(
        x.data_ptr(), out.data_ptr(), co.data_ptr(), t.wt.data_ptr(),
        t.cum.data_ptr(), t.k, t.ct, t.er.data_ptr(), t.ec.data_ptr(),
        t.fp.n, t.k1_cs.data_ptr(), t.k1_rs.data_ptr(), R1, R2, C,
        _stream())
    calls["k1_p1c"] += 1
    build.check(err, "k1_p1c")
    return out


# ---------------------------------------------------------------------------
# K5: the r2 passes alone
# ---------------------------------------------------------------------------

def axis1_plain(t: DevTables, x: torch.Tensor, which: str) -> torch.Tensor:
    """Plain K5: "p2" is the r2 DFT, then x mf; "p6" is x mi, then the r2
    inverse with the r1's tr_inv matrix."""
    if which == "p2":
        return gl.mulmod(gl.matmul_mod(t.g2, x), t.mf)
    if which == "p6":
        return gl.matmul_mod(t.tri, gl.mulmod(x, t.mi))
    raise ValueError(which)


def _split_ptrs(t: DevTables, inverse: bool):
    """The r2 pass's tables of one direction: (dft5, twiddles, shift
    exponents) of csrc/r2_split.cuh at a radix-5 L2, three nulls at a
    power-of-two one (csrc/axis_fft.cuh), then the row scales t_r_inv."""
    if t.dft5_f is None:
        return (None,) * 3 + (t.t_r_inv.data_ptr(),)
    return ((t.dft5_i if inverse else t.dft5_f).data_ptr(),
            (t.tw_i if inverse else t.tw_f).data_ptr(), _ptr(t.sh_exp),
            t.t_r_inv.data_ptr())


def axis1_pass(t: DevTables, x: torch.Tensor, which: str,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """K5: P2 or P6 over the whole register (kernels.py:1574-1594), as
    shift butterflies at a power-of-two L2 and the split form at a
    radix-5 one, on mf or mi and t_r_inv (the matrices g2 and tri are the
    plain version's)."""
    if which not in ("p2", "p6"):
        raise ValueError(which)
    _check(t, (x, out))
    if _on_cpu(x):
        r = axis1_plain(t, x, which)
        return r if out is None else out.copy_(r)
    R1, R2, C = t.shape
    if out is None:
        out = torch.empty_like(x)
    inverse = which == "p6"
    split = _split_ptrs(t, inverse)
    err = build.lib().prmers_k5_axis1(
        x.data_ptr(), out.data_ptr(), (t.mi if inverse else t.mf).data_ptr(),
        *split, int(inverse), R1, R2, C, _stream())
    calls["k5_axis1"] += 1
    build.check(err, "k5_axis1")
    return out


R5_PARTS = {"no-levels": 1, "move": 2}


def r2_split_part(t: DevTables, x: torch.Tensor, which: str,
                  part: str) -> torch.Tensor:
    """A cut-down body of K5's split form at a radix-5 L2, for the pass
    profiler alone: "no-levels" runs it without the butterfly levels,
    "move" makes the same loads and stores with an add in place of each
    product (csrc/r2_split.cuh). Neither computes the transform, so no
    plain version exists and no counter moves. CUDA tensors only."""
    if t.dft5_f is None or _on_cpu(x):
        raise ValueError("r2_split_part: a radix-5 plan on the card only")
    R1, R2, C = t.shape
    out = torch.empty_like(x)
    inverse = which == "p6"
    err = build.lib().prmers_r2_split_part(
        x.data_ptr(), out.data_ptr(), (t.mi if inverse else t.mf).data_ptr(),
        *_split_ptrs(t, inverse), int(inverse), R5_PARTS[part], R1, R2, C,
        _stream())
    build.check(err, f"r2_split_part {part}")
    return out


def r2_split_plain(t: DevTables, x: torch.Tensor,
                   inverse: bool) -> torch.Tensor:
    """A torch model of csrc/r2_split.cuh's schedule at L2 = 5 * M, for the
    tests (the wrappers' plain version stays axis1_plain, the dense
    product, which this equals mod P): "p6" (inverse: x mi first) or "p2";
    the 5-point DFT down stride M by dft5 (row and column 0 ones), the
    twiddles, the b levels of shift butterflies on the five M-point
    sub-columns (DIF, exponents sh_exp; the inverse multiplies b - a by
    2^(96 - e), and a - b at e = 0), the store of position (k1, p) to row
    k1 + 5 bitrev(p), then x mf (forward) or x t_r_inv (inverse)."""
    R1, L2, C = x.shape
    M = L2 // 5
    if inverse:
        x = gl.mulmod(x, t.mi)
    x0, x1 = gl.split(x.reshape(R1, 5, M, C))
    xs = [(x0[:, j], x1[:, j]) for j in range(5)]
    d5 = gl.split(t.dft5_i if inverse else t.dft5_f)
    tw = gl.split((t.tw_i if inverse else t.tw_f).reshape(5, 1, M, 1))
    ys = [xs[0]]
    for j in range(1, 5):
        ys[0] = gl.add(*ys[0], *xs[j])
    for k in range(1, 5):
        acc = xs[0]
        for j in range(1, 5):
            acc = gl.add(*acc, *gl.mul(*xs[j], d5[0][k, j], d5[1][k, j]))
        ys.append(gl.mul(*acc, tw[0][k], tw[1][k]))
    y0 = torch.stack([y[0] for y in ys], dim=1)      # (R1, 5, M, C)
    y1 = torch.stack([y[1] for y in ys], dim=1)
    exps = t.sh_exp.tolist()
    m = M // 2
    while m >= 1:
        sh = (R1, 5, M // (2 * m), 2, m, C)
        v0, v1 = y0.reshape(sh), y1.reshape(sh)
        a = (v0[:, :, :, 0], v1[:, :, :, 0])
        b = (v0[:, :, :, 1], v1[:, :, :, 1])
        s0, s1 = gl.add(*a, *b)
        d = gl.sub(*b, *a) if inverse else gl.sub(*a, *b)
        es = exps[M - 2 * m:M - m]
        w = [(pow(2, 96 - e, gl.P) if e else gl.P - 1) if inverse
             else pow(2, e, gl.P) for e in es]
        w0, w1 = (torch.tensor([f(v) for v in w], dtype=torch.int64,
                               device=x.device).reshape(1, 1, 1, m, 1)
                  for f in (lambda v: v & gl.M32, lambda v: v >> 32))
        d0, d1 = gl.mul(*d, w0, w1)
        y0 = torch.stack([s0, d0], dim=3).reshape(R1, 5, M, C)
        y1 = torch.stack([s1, d1], dim=3).reshape(R1, 5, M, C)
        m //= 2
    z = gl.join(y0, y1).reshape(R1, L2, C)
    rows = (torch.arange(5).reshape(5, 1) + 5 * torch.from_numpy(
        tfs.dif_freq_of_pos(M)).reshape(1, M)).reshape(L2).to(x.device)
    out = torch.empty_like(z)
    out[:, rows] = z
    if inverse:
        return gl.mulmod(out, t.t_r_inv.reshape(R1, L2, 1))
    return gl.mulmod(out, t.mf)


def axis_fft_model(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """A torch model of csrc/axis_fft.cuh's schedule along dim 0 of x (L,
    ...), L = 2^b <= 128, for the tests (the wrappers' plain versions stay
    the dense products, which this equals mod P). L <= 8: one radix-2 DIF
    (inverse: the mirrored DIT). Else, with x viewed as (L/8, 8): pass 1
    the levels m = L/2 ... 8 down dim 0 (stride 8: value [t, ty] is
    position 8t + ty, twiddle w_2m^(ty + 8 (t mod m/8))), pass 2 the
    8-point DIF (levels 4, 2, 1) along dim 1 ([g, i] is position 8g + i,
    the same view); the inverse runs pass 2's mirror first, then pass
    1's. DIF order out, and in for the inverse, as fourstep.dft_matrix."""
    L = x.shape[0]
    if L <= 8:
        return _dif(x, 0, inverse)
    rest = tuple(x.shape[1:])
    v = x.reshape((L // 8, 8) + rest)
    if inverse:
        v = _stride_levels(_dif(v, 1, True), True)
    else:
        v = _dif(_stride_levels(v, False), 1, False)
    return v.reshape((L,) + rest)


def _stride_levels(v: torch.Tensor, inverse: bool) -> torch.Tensor:
    """axis_fft.cuh's pass 1 on v (T, 8, ...): the DIF levels m = 4T ...
    8 down dim 0, or with inverse the DIT levels 8 ... 4T by the inverse
    roots."""
    T = v.shape[0]
    rest = tuple(v.shape[2:])
    levels = [8 << i for i in range(T.bit_length() - 1)]
    for m in (levels if inverse else levels[::-1]):
        mt = m // 8
        w = tfs.root_554(2 * m)
        w = pow(w, -1, gl.P) if inverse else w
        tw = _consts([[pow(w, ty + 8 * tt, gl.P) for ty in range(8)]
                      for tt in range(mt)], v).reshape(
                          (1, mt, 8) + (1,) * len(rest))
        u = v.reshape((T // (2 * mt), 2, mt, 8) + rest)
        a, b = u[:, 0], u[:, 1]
        if inverse:
            b = gl.mulmod(b, tw)
            a, b = _add(a, b), _sub(a, b)
        else:
            a, b = _add(a, b), gl.mulmod(_sub(a, b), tw)
        v = torch.stack([a, b], dim=1).reshape((T, 8) + rest)
    return v


def p1_carry_model(t: DevTables, x: torch.Tensor,
                   co: torch.Tensor) -> torch.Tensor:
    """K1 as csrc/k1_p1c.cu computes it, for the tests: the plain
    injection and halve, x k1_cs, the r1 DFT by axis_fft_model, x k1_rs
    (equal mod P to p1_carry_plain)."""
    return _p1_fft_model(t, _p1_inject(t, x, co))


def _p1_fft_model(t: DevTables, y: torch.Tensor) -> torch.Tensor:
    """The halve where wrapped, x k1_cs, the r1 DFT by axis_fft_model and x
    k1_rs: K1 and K4 forward after their injections, as the CUDA kernels
    compute them (equal mod P to _p1_dft)."""
    y = gl.join(*gl.halve_where(*gl.split(y), _wrap_mask(t)))
    y = axis_fft_model(gl.mulmod(y, t.k1_cs.unsqueeze(-1)), False)
    return gl.mulmod(y, t.k1_rs.unsqueeze(-1))


def axis1_model(t: DevTables, x: torch.Tensor, which: str) -> torch.Tensor:
    """K5 (and K2's r2 launches) at a power-of-two L2 as csrc/axis_fft.cuh
    computes them, for the tests: "p2" the r2 DFT by axis_fft_model, x mf;
    "p6" x mi, the inverse, x t_r_inv (equal mod P to axis1_plain)."""
    if which not in ("p2", "p6"):
        raise ValueError(which)
    R1, L2, C = x.shape
    inverse = which == "p6"
    if inverse:
        x = gl.mulmod(x, t.mi)
    y = axis_fft_model(x.transpose(0, 1).contiguous(), inverse)
    y = y.transpose(0, 1).contiguous()
    if inverse:
        return gl.mulmod(y, t.t_r_inv.reshape(R1, L2, 1))
    return gl.mulmod(y, t.mf)


# csrc/axis_dft.cuh's modes; "k3" is K3a and K4 inverse's body, and K4
# forward's move-only body is K1's (the same table words, no carries)
AXIS_MOVES = {"k1": 0, "k4f": 0, "p2": 1, "p6": 2, "k3": 3}


def axis_fft_move(t: DevTables, x: torch.Tensor, which: str,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The move-only body of csrc/axis_fft.cuh at L = 64 or 128, for the
    pass profiler alone: K1 ("k1"), K3a and K4 inverse ("k3") or K4
    forward ("k4f") on the r1 axis, or K5's "p2" / "p6" on the r2 axis,
    with its loads, shared-memory exchange and stores, an add in place of
    every product and no butterflies. It computes no transform, so no
    plain version exists and no counter moves. CUDA tensors only."""
    if which not in AXIS_MOVES:
        raise ValueError(which)
    if _on_cpu(x):
        raise ValueError("axis_fft_move: on the card only")
    _check(t, (x, out))
    R1, R2, C = t.shape
    if out is None:
        out = torch.empty_like(x)
    if which in ("k1", "k4f"):
        dims, tab, cs, rs = (1, R1, R2), None, t.k1_cs, t.k1_rs
    elif which == "k3":
        dims, tab, cs, rs = (1, R1, R2), None, None, t.k3_rs
    else:
        dims, cs, rs = (R1, R2, 1), None, t.t_r_inv
        tab = t.mf if which == "p2" else t.mi
    err = build.lib().prmers_axis_fft_move(
        x.data_ptr(), out.data_ptr(), _ptr(tab), _ptr(cs), _ptr(rs),
        AXIS_MOVES[which], *dims, C, _stream())
    build.check(err, f"axis_fft_move {which}")
    return out


# ---------------------------------------------------------------------------
# K2, K6, K6b: the C-transform
# ---------------------------------------------------------------------------

def _slot_mat(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """v (R, ca, 128): out[b, j, k] = sum_l v[b, j, l] * M[j][l][k]."""
    return gl.matmul_mod(v.permute(1, 0, 2), M).permute(1, 0, 2)


def _head_op(v: torch.Tensor, op: str, u: torch.Tensor | None):
    if op == "sqr":
        return gl.mulmod(v, v)
    if op == "mul":
        return gl.mulmod(v, u.reshape(v.shape))
    if op == "":
        return v
    raise ValueError(op)


def _inv_half(t: DevTables, v: torch.Tensor) -> torch.Tensor:
    """The Mi slot products, then the inverse lane DFT; (R1, R2, C) out."""
    v = gl.matmul_mod(t.lane_i, _slot_mat(v, t.Mi))
    return v.reshape(t.shape)


def fused_c_plain(t: DevTables, x: torch.Tensor, mode: str,
                  u: torch.Tensor | None = None,
                  r2fold: bool = True) -> torch.Tensor:
    """Plain K2 (r2fold) or K6: [P2], lane DFT, slot products, the mode,
    and (unless "fwd") the mirror back, [then P6]."""
    R1, R2, C = t.shape
    y = axis1_plain(t, x, "p2") if r2fold else x
    v = gl.matmul_mod(t.lane_f, y.reshape(R1 * R2, C // 128, 128))
    v = _slot_mat(v, t.Mf)
    if mode == "fwd":
        return v.reshape(t.shape).contiguous()
    if mode not in ("sqr", "mul"):
        raise ValueError(mode)
    y = _inv_half(t, _head_op(v, mode, u))
    return (axis1_plain(t, y, "p6") if r2fold else y).contiguous()


def fused_c_pass(t: DevTables, x: torch.Tensor, mode: str,
                 u: torch.Tensor | None = None,
                 out: torch.Tensor | None = None,
                 r2fold: bool = True) -> torch.Tensor:
    """The C-transform on the K1 output (r2fold: K2, with P2/P6 inside) or
    on the P2 output (r2fold off: K6); mode "sqr", "mul" (u = spectral
    multiplicand) or "fwd" (stop after the forward C-transform)."""
    if mode not in MODES:
        raise ValueError(mode)
    if (mode == "mul") != (u is not None):
        raise ValueError("u is the operand of mode 'mul' only")
    _check(t, (x, u, out))
    if _on_cpu(x):
        r = fused_c_plain(t, x, mode, u, r2fold)
        return r if out is None else out.copy_(r)
    R1, R2, C = t.shape
    if out is None:
        out = torch.empty_like(x)
    lib = build.lib()
    if r2fold:
        name = "k2_fused_c"
        fwd, inv = _split_ptrs(t, False), _split_ptrs(t, True)
        err = lib.prmers_k2_fused_c(
            x.data_ptr(), out.data_ptr(), _ptr(u), MODES[mode],
            t.mf.data_ptr(), t.cs_f.data_ptr(), t.cs_i.data_ptr(),
            t.mi.data_ptr(), fwd[0], inv[0], fwd[1], inv[1], fwd[2], fwd[3],
            R1, R2, C, _stream())
    else:
        name = "k6_fused_c"
        err = lib.prmers_k6_fused_c(
            x.data_ptr(), out.data_ptr(), _ptr(u), MODES[mode],
            t.cs_f.data_ptr(), t.cs_i.data_ptr(), R1 * R2, C, _stream())
    calls[name] += 1
    build.check(err, name)
    return out


def fused_c_invh_plain(t: DevTables, x: torch.Tensor, op: str,
                       u: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K6b: the head op ("sqr", "mul" or ""), then the inverse
    half."""
    R1, R2, C = t.shape
    v = _head_op(x.reshape(R1 * R2, C // 128, 128), op, u)
    return _inv_half(t, v).contiguous()


def fused_c_invh_pass(t: DevTables, x: torch.Tensor, op: str,
                      u: torch.Tensor | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """K6b on K6 "fwd"'s spectral output (kernels.py:1176-1219)."""
    if op not in HEAD_OPS:
        raise ValueError(op)
    if (op == "mul") != (u is not None):
        raise ValueError("u is the operand of op 'mul' only")
    _check(t, (x, u, out))
    if _on_cpu(x):
        r = fused_c_invh_plain(t, x, op, u)
        return r if out is None else out.copy_(r)
    R1, R2, C = t.shape
    if out is None:
        out = torch.empty_like(x)
    err = build.lib().prmers_k6b_fused_c_invh(
        x.data_ptr(), out.data_ptr(), _ptr(u), HEAD_OPS[op],
        t.cs_i.data_ptr(), R1 * R2, C, _stream())
    calls["k6b_fused_c_invh"] += 1
    build.check(err, "k6b_fused_c_invh")
    return out


def _add(a, b):
    return gl.join(*gl.add(*gl.split(a), *gl.split(b)))


def _sub(a, b):
    return gl.join(*gl.sub(*gl.split(a), *gl.split(b)))


def _consts(vals, like: torch.Tensor) -> torch.Tensor:
    """A (nested) list of Python ints mod P as a packed tensor on like's
    device (built from ints: numpy would take a list mixing small and
    large ones as float64)."""
    shape = np.shape(np.asarray(vals, dtype=object))
    flat = np.asarray(vals, dtype=object).reshape(-1)
    a = np.array([int(v) % gl.P for v in flat], dtype=np.uint64)
    return gl.from_numpy_u64(a.reshape(shape), like.device)


def _dif(x: torch.Tensor, dim: int, inverse: bool) -> torch.Tensor:
    """The length-L DFT along dim by root_554(L) (L = x.shape[dim]): DIF
    butterflies, natural in, bit-reversed out; with inverse the mirror,
    DIT butterflies by the inverse root, bit-reversed in, natural out."""
    v = x.movedim(dim, -1)
    L = v.shape[-1]
    lead = v.shape[:-1]
    m = 1 if inverse else L // 2
    while 1 <= m < L:
        w = tfs.root_554(2 * m)
        w = pow(w, -1, gl.P) if inverse else w
        tw = _consts([pow(w, jj, gl.P) for jj in range(m)], v)
        u = v.reshape(lead + (L // (2 * m), 2, m))
        a, b = u[..., 0, :], u[..., 1, :]
        if inverse:
            b = gl.mulmod(b, tw)
            a, b = _add(a, b), _sub(a, b)
        else:
            a, b = _add(a, b), gl.mulmod(_sub(a, b), tw)
        v = torch.stack([a, b], dim=-2).reshape(lead + (L,))
        m = m * 2 if inverse else m // 2
    return v.movedim(-1, dim)


def c_fft_plain(t: DevTables, x: torch.Tensor, fwd: bool, op: str,
                inv: bool, u: torch.Tensor | None = None) -> torch.Tensor:
    """A torch model of csrc/fused_c_row.cuh's schedule, for the tests (the
    wrappers' plain versions stay fused_c_plain / fused_c_invh_plain, the
    dense products, which this equals mod P). Per row of C = ca * 128:

      fwd  the lane DIF over the ca slots as two register passes (ca = N1
           * N2, fourstep.lane_split): the N1-point DIF down the top
           bits of the slot index, the twiddle omega_ca^(lo bitrev(i)),
           the N2-point DIF; x cs_f; per slot the 128-point DFT as 16 x 8
           (fourstep.c_slot_schedule): the 16-point DIF down stride 8, x
           omega_128^(t bitrev4(m)), the 8-point DIF, then the store in
           natural order;
      op   "sqr", "mul" (x u, natural order) or "";
      inv  the mirror: the 8-point inverse DIT, x omega_128^(-q
           bitrev4(h)), the 16-point inverse DIT, x cs_i, the N2-point
           inverse DIT, x omega_ca^(-lo bitrev(hi)), the N1-point inverse
           DIT.

    K6 is (True, op, mode != "fwd"), K6b (False, op, True)."""
    R1, R2, C = t.shape
    ca = C // 128
    n1, n2 = tfs.lane_split(ca)
    R = R1 * R2
    rev1 = tfs.dif_freq_of_pos(n1)
    br = torch.from_numpy(tfs.dif_freq_of_pos(128))
    w128 = tfs.root_554(128)
    tw128 = tfs.c_slot_schedule()["tw"].T             # [m, t] / [h, q]

    def lane_tw(sign):
        """omega_ca^(sign lo bitrev(i)) at [i, lo]."""
        return _consts([[pow(tfs.root_554(ca), sign * lo * int(rev1[i]),
                             gl.P) for lo in range(n2)] for i in range(n1)],
                       x).reshape(n1, n2, 1)

    def slot_tw(sign):
        return _consts([[pow(w128, sign * int(e), gl.P) for e in row]
                        for row in tw128], x)

    v = x.reshape(R, ca, 128)
    if fwd:
        v = _dif(v.reshape(R, n1, n2, 128), 1, False)
        if n2 > 1:
            v = _dif(gl.mulmod(v, lane_tw(1)), 2, False)
        v = gl.mulmod(v.reshape(R, ca, 128), t.cs_f)
        v = _dif(v.reshape(R, ca, 16, 8), 2, False)
        v = _dif(gl.mulmod(v, slot_tw(1)), 3, False).reshape(R, ca, 128)
        v = v[..., br]                  # bit-reversed -> natural
    v = _head_op(v, op, u)
    if not inv:
        return v.reshape(t.shape).contiguous()
    v = _dif(v[..., br].reshape(R, ca, 16, 8), 3, True)
    v = _dif(gl.mulmod(v, slot_tw(-1)), 2, True).reshape(R, ca, 128)
    v = gl.mulmod(v, t.cs_i).reshape(R, n1, n2, 128)
    if n2 > 1:
        v = gl.mulmod(_dif(v, 2, True), lane_tw(-1))
    v = _dif(v, 1, True)
    return v.reshape(t.shape).contiguous()


C_PARTS = {"no-slot-levels": 1, "move": 2}


def fused_c_part(t: DevTables, x: torch.Tensor, part: str) -> torch.Tensor:
    """A cut-down body of the row kernel (K6 in mode "sqr") at C = 2048 or
    8192, for the pass profiler alone: "no-slot-levels" runs it without
    the 128-point butterflies, "move" makes the same loads and stores with
    an add in place of each product (csrc/fused_c_row.cuh). Neither
    computes the transform, so no plain version exists and no counter
    moves. CUDA tensors only."""
    R1, R2, C = t.shape
    if C not in (2048, 8192) or _on_cpu(x):
        raise ValueError("fused_c_part: C = 2048 or 8192 on the card only")
    _check(t, (x,))
    out = torch.empty_like(x)
    err = build.lib().prmers_fused_c_part(
        x.data_ptr(), out.data_ptr(), C_PARTS[part], t.cs_f.data_ptr(),
        t.cs_i.data_ptr(), R1 * R2, C, _stream())
    build.check(err, f"fused_c_part {part}")
    return out


def fused_mid(t: DevTables, s: torch.Tensor, mode: str,
              u: torch.Tensor | None = None) -> torch.Tensor:
    """The C-transform span of a step, in place on s, with the branch the
    JAX `_fused_mid` (kernels.py:1597-1616) takes: K2 when the r2 passes
    fold and the halves need no split; else K5 P2, then K6 (or K6 "fwd" +
    K6b when split), then K5 P6. Mode "fwd" stops at the spectral value."""
    fp = t.fp
    split = tfs.fc_split(fp)
    if tfs.use_r2fold(fp) and not split:
        return fused_c_pass(t, s, mode, u=u, out=s)
    s = axis1_pass(t, s, "p2", out=s)
    if not split:
        s = fused_c_pass(t, s, mode, u=u, out=s, r2fold=False)
        if mode == "fwd":
            return s
    else:
        s = fused_c_pass(t, s, "fwd", out=s, r2fold=False)
        if mode == "fwd":
            return s
        s = fused_c_invh_pass(t, s, mode, u=u, out=s)
    return axis1_pass(t, s, "p6", out=s)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def p7_dft_plain(t: DevTables, x: torch.Tensor, a: int = 1) -> torch.Tensor:
    """K3's first half: per-r2 folded r1 inverse DFT, double where
    wrapped, canon, optional x a and canon. Canonical out."""
    y = gl.matmul_mod(t.k3_mats, x.permute(1, 0, 2)).permute(1, 0, 2)
    return _p7_epilogue(t, y, a)


def _p7_epilogue(t: DevTables, y: torch.Tensor, a: int) -> torch.Tensor:
    y0, y1 = gl.canon(*gl.double_where(*gl.split(y), _wrap_mask(t)))
    if a != 1:
        y0, y1 = gl.canon(*gl.mul_small(y0, y1, a))
    return gl.join(y0, y1)


def p7_dft_model(t: DevTables, x: torch.Tensor, a: int = 1) -> torch.Tensor:
    """K3's first half (K3a) as csrc/k3_p7c.cu computes it, for the tests:
    the r1 inverse DFT by axis_fft_model down dim 0, x k3_rs, then
    p7_dft_plain's double, canon and x a (bit for bit equal to it: both
    canonical)."""
    y = axis_fft_model(x, True)
    return _p7_epilogue(t, gl.mulmod(y, t.k3_rs.unsqueeze(-1)), a)


def carry_plain(t: DevTables, y: torch.Tensor, sub2: bool = False,
                s2: int = 2):
    """K3's second half on canonical y: optional + (M_p - s2), the
    digit/carry split, the lane-ripple rounds inside each carry unit, the
    residual added unsplit; returns (digits, unit out-carries)
    (kernels.py:562-609, :655-667)."""
    w = _units(t, t.widths.to(torch.int64))
    y0, y1 = gl.split(_units(t, y))
    if sub2:
        add = (1 << w) - 1
        add.view(-1)[0] -= s2            # global digit 0 only
        y0, y1 = gl.norm(y0 + add, y1)   # y < P, so y + add < 2^64: exact
    d, acc = _ripple(y0, y1, w, t.rounds)
    return d.reshape(t.shape), acc


def _ripple(y0, y1, w, rounds: int):
    """The digit/carry split of y = (y0, y1) by the widths w, `rounds`
    shift-by-one rounds inside each unit (the last axis; the unit's first
    digit takes 0), then a last shift whose residual is added unsplit;
    returns (digits, the sum of what left each unit's last digit), the
    carry of K3 and K7 (kernels.py:562-609, :1345-1404)."""
    mk = (1 << w) - 1
    d = y0 & mk
    # y >> w with w in [1, 32): < 2^(64-w), a non-negative int64
    c = gl.join(((y0 >> w) | (y1 << (32 - w))) & gl.M32, y1 >> w)
    acc = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)

    def shift(c):
        sh = torch.zeros_like(c)
        sh[..., 1:] = c[..., :-1]
        return sh, c[..., -1]

    for _ in range(rounds):
        sh, out = shift(c)
        acc = acc + out
        yy = d + sh
        d = yy & mk
        c = yy >> w
    sh, out = shift(c)
    acc = acc + out
    d = (d + (sh & gl.M32)) & gl.M32
    return d, acc


def p7_carry_plain(t: DevTables, x: torch.Tensor, a: int = 1,
                   sub2: bool = False, s2: int = 2):
    return carry_plain(t, p7_dft_plain(t, x, a), sub2, s2)


K3_TW = 32      # digits of a tile row in K3's one launch (csrc/k3_tile.cuh)
K3_HDR = 4      # its scratch words before the flags (csrc/k3_p7c.cu)


def k3_scratch_words(shape: tuple, rounds: int) -> int:
    """Words of K3's scratch for an (L1, R2, C) register: the header, a
    flag a tile and rounds + 1 edge words a tile row (tiles of K3_TW
    columns of one r2 slab, all L1 rows)."""
    L1, R2, C = shape
    tiles = R2 * C // K3_TW
    return K3_HDR + tiles * (1 + L1 * (rounds + 1))


def carry_tiles_model(t: DevTables, y: torch.Tensor, sub2: bool = False,
                      s2: int = 2):
    """K3's carry as its one launch computes it (csrc/k3_p7c.cu), for the
    tests: canonical y cut into tiles of K3_TW digits of a row; each tile's
    rounds with zeros in give the carries that leave its last digit in
    rounds 0 ... rounds (its edge words); each tile then runs the rounds
    again from the split with the edge words of the tile before it in its
    unit entering its first digit (zeros for a unit's first tile); a
    unit's out-carry is the sum of its last tile's edge words. Returns
    (digits, unit out-carries), as carry_plain."""
    R1, R2, C = t.shape
    nb, tpu = C // K3_TW, t.ct // K3_TW
    tiles = (R1, R2, nb, K3_TW)
    w = t.widths.to(torch.int64).reshape(tiles)
    y0, y1 = gl.split(y.reshape(tiles))
    if sub2:
        add = (1 << w) - 1
        add[0, 0, 0, 0] -= s2            # the register's digit 0
        y0, y1 = gl.norm(y0 + add, y1)
    _, edges = _tile_rounds(y0, y1, w, t.rounds, None)
    cin = torch.zeros_like(edges)
    cin[:, :, 1:] = edges[:, :, :-1]
    cin[:, :, ::tpu] = 0                 # a unit's first tile
    d, _ = _tile_rounds(y0, y1, w, t.rounds, cin)
    co = edges.sum(-1).reshape(R1, R2, nb // tpu, tpu)[..., -1]
    return d.reshape(t.shape), co


def _tile_rounds(y0, y1, w, rounds: int, cin):
    """csrc/k3_tile.cuh's k3_row_carry on every tile row at once (the last
    axis): the split of y = (y0, y1) by the widths w, then rounds + 1
    shifts, the first digit taking cin[..., r] in round r (zeros with cin
    None), the last one's residual added unsplit; returns (digits, the
    carry that left the last digit in each round, (..., rounds + 1))."""
    mk = (1 << w) - 1
    d = y0 & mk
    c = gl.join(((y0 >> w) | (y1 << (32 - w))) & gl.M32, y1 >> w)
    outs = []
    for r in range(rounds + 1):
        outs.append(c[..., -1])
        sh = torch.zeros_like(c)
        sh[..., 1:] = c[..., :-1]
        if cin is not None:
            sh[..., 0] = cin[..., r]
        if r < rounds:
            yy = d + sh
            d, c = yy & mk, yy >> w
        else:
            d = (d + (sh & gl.M32)) & gl.M32
    return d, torch.stack(outs, -1)


def p7_carry_model(t: DevTables, x: torch.Tensor, a: int = 1,
                   sub2: bool = False, s2: int = 2):
    """K3 as its one launch computes it: p7_dft_model, then
    carry_tiles_model (bit for bit equal to p7_carry_plain)."""
    return carry_tiles_model(t, p7_dft_model(t, x, a), sub2, s2)


def p7_carry_pass(t: DevTables, x: torch.Tensor, a: int = 1,
                  sub2: bool = False, out: torch.Tensor | None = None,
                  co_out: torch.Tensor | None = None, s2: int = 2):
    """K3 on the C-transform's output: returns (digits, unit out-carries
    (R1, R2, T)). With sub2, s2 is what comes off the register's digit 0:
    2, or 0 on a mesh rank that does not hold global digit 0
    (sharded_pallas.py:493-498). On the card one launch, which hands the
    carries between tiles through t.k3_scratch: one call at a time on a
    DevTables' scratch (the engines' one stream)."""
    if sub2 and a != 1:
        raise ValueError("the LL sub2 step never rides the x a path")
    if not 0 < a < (1 << 32):
        raise ValueError(f"multiplier a={a} must be in [1, 2^32)")
    _check(t, (x, out), (co_out,))
    if _on_cpu(x):
        d, co = p7_carry_plain(t, x, a, sub2, s2)
        if out is not None:
            d = out.copy_(d)
        if co_out is not None:
            co = co_out.copy_(co)
        return d, co
    R1, R2, C = t.shape
    if out is None:
        out = torch.empty_like(x)
    if co_out is None:
        co_out = torch.empty(t.row_carry_shape, dtype=torch.int64,
                             device=x.device)
    err = build.lib().prmers_k3_p7c(
        x.data_ptr(), out.data_ptr(), co_out.data_ptr(),
        t.k3_rs.data_ptr(), t.er.data_ptr(), t.ec.data_ptr(), t.fp.n,
        t.widths.data_ptr(), t.rounds, a, int(a != 1), int(sub2), s2,
        R1, R2, C, t.ct, t.k3_scratch.data_ptr(), t.k3_scratch.numel(),
        _stream())
    calls["k3_p7c"] += 1
    build.check(err, "k3_p7c")
    return out, co_out


# ---------------------------------------------------------------------------
# K4: the r1 passes alone (the block-carry pipeline and the hybrid)
# ---------------------------------------------------------------------------

def inject_block_carries_plain(t: DevTables, x: torch.Tensor,
                               co: torch.Tensor) -> torch.Tensor:
    """Block b's carry, spread base-2^width over the first bk digits of
    block b + 1 (the last block's over block 0's: the mod-M_p fold), added
    to the digits (kernels.py:1505-1527)."""
    parts = inject_parts(torch.roll(co.reshape(-1), 1), t.bwt, t.bcum)
    y = x.clone()
    y[:, 0, :t.bk] += parts              # digits < 2^32: no u64 wrap
    return y


def axis0_plain(t: DevTables, x: torch.Tensor, inverse: bool,
                co: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K4. Forward: with block carries co, their injection first
    (the JAX runs it as an XLA strip before _p1_pass), then the wrap halve
    and the per-r2 folded r1 DFT (tr_fwd_w). Inverse: the r1 inverse DFT
    (iw_inv), the wrap double and canon."""
    if inverse:
        if co is not None:
            raise ValueError("K4 inverse takes no carries")
        return p7_dft_plain(t, x)
    if co is not None:
        x = inject_block_carries_plain(t, x, co)
    return _p1_dft(t, x)


def axis0_model(t: DevTables, x: torch.Tensor, inverse: bool,
                co: torch.Tensor | None = None) -> torch.Tensor:
    """K4 as csrc/k4_axis0.cu computes it, for the tests: forward, the
    plain injection, then the halve, x k1_cs, axis_fft_model and x k1_rs
    (equal mod P to axis0_plain); inverse, p7_dft_model with a = 1 (bit
    for bit)."""
    if inverse:
        if co is not None:
            raise ValueError("K4 inverse takes no carries")
        return p7_dft_model(t, x)
    if co is not None:
        x = inject_block_carries_plain(t, x, co)
    return _p1_fft_model(t, x)


def axis0_pass(t: DevTables, x: torch.Tensor, inverse: bool,
               co: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """K4: P1 (with the unrolled (R1, 1) block carries co injected, when
    given) or P7 (kernels.py:1619-1639) over the whole register; on the
    card as shift butterflies on k1_cs, k1_rs (forward) or k3_rs
    (inverse), never the matrices k1_mats or k3_mats."""
    if inverse and co is not None:
        raise ValueError("K4 inverse takes no carries")
    if co is not None and t.bwt is None:
        raise ValueError("K4 forward with carries needs the block spread "
                         "tables (bwt, bcum), which this view lacks")
    _check(t, (x, out), (co,), block=True)
    if _on_cpu(x):
        r = axis0_plain(t, x, inverse, co)
        return r if out is None else out.copy_(r)
    R1, R2, C = t.shape
    if out is None:
        out = torch.empty_like(x)
    err = build.lib().prmers_k4_axis0(
        x.data_ptr(), out.data_ptr(), int(inverse), _ptr(co),
        _ptr(t.bwt), _ptr(t.bcum), t.bk, t.er.data_ptr(),
        t.ec.data_ptr(), t.fp.n, None if inverse else t.k1_cs.data_ptr(),
        (t.k3_rs if inverse else t.k1_rs).data_ptr(), R1, R2, C, _stream())
    calls["k4_axis0"] += 1
    build.check(err, "k4_axis0")
    return out


# ---------------------------------------------------------------------------
# K7: the carry over each r1 block
# ---------------------------------------------------------------------------

def block_carry_plain(t: DevTables, y: torch.Tensor, a: int = 1,
                      rounds: int | None = None):
    """Plain K7 on K4 inverse's canonical y: optional canon(y * a), then
    the carry of each r1 block of R2*C digits in flat order with `rounds`
    ripple rounds (default t.rounds, K7's rule; the plain K8 is this with
    fourstep.k8_rounds); returns (digits, block out-carries (R1, 1))."""
    R1 = t.shape[0]
    y0, y1 = gl.split(y.reshape(R1, -1))
    if a != 1:
        y0, y1 = gl.canon(*gl.mul_small(y0, y1, a))
    w = t.widths.to(torch.int64).reshape(R1, -1)
    d, acc = _ripple(y0, y1, w, t.rounds if rounds is None else rounds)
    return d.reshape(t.shape), acc.reshape(R1, 1)


def block_carry_pass(t: DevTables, y: torch.Tensor, a: int = 1,
                     out: torch.Tensor | None = None,
                     co_out: torch.Tensor | None = None):
    """K7 (kernels.py:1407-1443): returns (digits, block out-carries
    (R1, 1)). Not in place: a CUDA block reads digits before its slab that
    another block writes."""
    return _block_carry(t, y, a, t.rounds, "k7_block_carry", out, co_out)


def block_carry_local(t: DevTables, y: torch.Tensor, a: int = 1,
                      out: torch.Tensor | None = None,
                      co_out: torch.Tensor | None = None):
    """K8 (sharded_pallas.py:201-235): K7's kernel with K8's round rule
    (fourstep.k8_rounds, kept in t.k8_rounds: its numpy min over the
    widths costs milliseconds at n = 2^23) on the r1 blocks of t, a rank's
    r1-sharded view on the mesh; returns (digits, block out-carries
    (R1/s, 1)). Its plain version is block_carry_plain(t, y, a,
    t.k8_rounds)."""
    return _block_carry(t, y, a, t.k8_rounds, "k8_local", out, co_out)


def _block_carry(t: DevTables, y: torch.Tensor, a: int, rounds: int,
                 name: str, out: torch.Tensor | None,
                 co_out: torch.Tensor | None):
    if not 0 < a < (1 << 32):
        raise ValueError(f"multiplier a={a} must be in [1, 2^32)")
    if out is not None and out.data_ptr() == y.data_ptr():
        raise ValueError("K7 cannot run in place")
    _check(t, (y, out), (co_out,), block=True)
    if _on_cpu(y):
        d, co = block_carry_plain(t, y, a, rounds)
        if out is not None:
            d = out.copy_(d)
        if co_out is not None:
            co = co_out.copy_(co)
        return d, co
    R1, R2, C = t.shape
    if out is None:
        out = torch.empty_like(y)
    if co_out is None:
        co_out = torch.empty(t.block_carry_shape, dtype=torch.int64,
                             device=y.device)
    err = build.lib().prmers_k7_block_carry(
        y.data_ptr(), out.data_ptr(), co_out.data_ptr(),
        t.widths.data_ptr(), a, int(a != 1), rounds, R1, R2 * C,
        _stream())
    calls[name] += 1
    build.check(err, name)
    return out, co_out


# ---------------------------------------------------------------------------
# Steps (kernels.py:1665-1743)
# ---------------------------------------------------------------------------

def _block_step(t: DevTables, x, co, mode: str, u=None, a: int = 1,
                out=None, co_out=None):
    """The block-carry step (K4, fused_mid, K4 inverse, K7), or with
    fourstep.use_xla_carry the hybrid (K4 without carries, fused_mid, K4
    inverse, carry_full; the carries pass through)."""
    hybrid = tfs.use_xla_carry(t.fp)
    _check(t, (), (co, co_out), block=True)
    s = axis0_pass(t, x, False, co=None if hybrid else co, out=out)
    s = fused_mid(t, s, mode, u=u)
    if mode == "fwd":
        return s
    z = axis0_pass(t, s, True)
    if not hybrid:
        return block_carry_pass(t, z, a, out=s, co_out=co_out)
    d = carry_ops.carry_full(z.reshape(-1), t.widths.reshape(-1), a=a)
    s.copy_(d.reshape(t.shape))
    if co_out is None or co_out is co:
        return s, co
    return s, co_out.copy_(co)


def square_step(t: DevTables, x, co, a: int = 1, sub2: bool = False,
                out=None, co_out=None):
    """One x^2 * a (or x^2 - 2 with sub2, row carry only) iteration;
    returns (x, co)."""
    if not tfs.use_rowcarry(t.fp):
        if sub2:
            raise ValueError("the LL sub2 step needs the row-carry pipeline")
        return _block_step(t, x, co, "sqr", a=a, out=out, co_out=co_out)
    s = p1_carry_pass(t, x, co, out=out)
    s = fused_mid(t, s, "sqr")
    return p7_carry_pass(t, s, a, sub2, out=s, co_out=co_out)


def mul_step(t: DevTables, x, co, u, a: int = 1, out=None, co_out=None):
    """x * multiplicand(u) * a; u is fwd_step's spectral output."""
    if not tfs.use_rowcarry(t.fp):
        return _block_step(t, x, co, "mul", u=u, a=a, out=out,
                           co_out=co_out)
    s = p1_carry_pass(t, x, co, out=out)
    s = fused_mid(t, s, "mul", u=u)
    return p7_carry_pass(t, s, a, out=s, co_out=co_out)


def fwd_step(t: DevTables, x, co, out=None):
    """Forward transform only: the spectral multiplicand of (x, co)."""
    if not tfs.use_rowcarry(t.fp):
        return _block_step(t, x, co, "fwd", out=out)
    s = p1_carry_pass(t, x, co, out=out)
    return fused_mid(t, s, "fwd")


# ---------------------------------------------------------------------------
# K9: the whole chain (kernels.py:1755-1967)
# ---------------------------------------------------------------------------

def chain_multipliers(a_vec, device) -> torch.Tensor:
    """Multipliers a_k in [1, 2^32) -> K9's int64 buffer of CHAIN_K entries,
    padded with ones (the JAX pads its a buffer the same way, :1929)."""
    a = [int(v) for v in a_vec]
    if len(a) > CHAIN_K:
        raise ValueError(f"a chain takes at most CHAIN_K={CHAIN_K} "
                         f"multipliers (got {len(a)})")
    if any(not 0 < v < (1 << 32) for v in a):
        raise ValueError("multipliers must be in [1, 2^32)")
    buf = torch.ones(CHAIN_K, dtype=torch.int64)
    buf[:len(a)] = torch.tensor(a, dtype=torch.int64)
    return buf.to(device)


def square_chain_plain(t: DevTables, x: torch.Tensor, co: torch.Tensor,
                       a_vec, count: int):
    """Plain K9: count squarings x^2 * a_k through the plain K1, the plain
    C-transform and the plain K3; returns (digits, unit out-carries)."""
    a = [int(v) for v in a_vec[:count]]
    for ak in a:
        s = p1_carry_plain(t, x, co)
        s = fused_c_plain(t, s, "sqr")
        x, co = p7_carry_plain(t, s, ak)
    return x, co


def square_chain_model(t: DevTables, x: torch.Tensor, co: torch.Tensor,
                       a_vec, count: int):
    """K9 as csrc/k9_chain.cuh computes it, for the tests: per squaring its
    six phases in order, each the torch model of the standalone launch
    whose body it runs: K1 (p1_carry_model), K2a (axis1_model "p2"), the
    row C-transform with the square (c_fft_plain, which either of the
    kernel's row forms computes), K2c (axis1_model "p6"),
    K3a (p7_dft_model, x a_k) and K3b (carry_plain); at L2 = 1 the kernel's
    row phase takes K2a's x mf and K2c's x mi, x t_r_inv, the same
    products. Bit for bit equal to square_chain_plain: K3a's output is
    canonical."""
    for ak in [int(v) for v in a_vec[:count]]:
        s = p1_carry_model(t, x, co)
        s = axis1_model(t, s, "p2")
        s = c_fft_plain(t, s, True, "sqr", True)
        s = axis1_model(t, s, "p6")
        x, co = carry_plain(t, p7_dft_model(t, s, ak))
    return x, co


K9_PHASES = ("k1", "k2a", "row", "k2c", "k3a", "k3b")
K9_PARTS = {"full": 0, "move": 1}
K9_FORMS = {"rule": 0, "fused": 1, "split": 2}


def _k9_launch(t: DevTables, x: torch.Tensor, co: torch.Tensor,
               a: torch.Tensor, count: int, part=None) -> int:
    """prmers_k9_chain, or with part = (part, phases, form)
    prmers_k9_chain_part."""
    R1, R2, C = t.shape
    args = (x.data_ptr(), co.data_ptr(), a.data_ptr(), count,
            t.k1_cs.data_ptr(), t.k1_rs.data_ptr(), t.wt.data_ptr(),
            t.cum.data_ptr(), t.k, t.er.data_ptr(), t.ec.data_ptr(), t.fp.n,
            t.mf.data_ptr(), t.mi.data_ptr(), t.t_r_inv.data_ptr(),
            t.cs_f.data_ptr(), t.cs_i.data_ptr(), t.k3_rs.data_ptr(),
            t.widths.data_ptr(), t.rounds, R1, R2, C)
    if part is None:
        return build.lib().prmers_k9_chain(*args, _stream())
    return build.lib().prmers_k9_chain_part(*args, *part, _stream())


def square_chain(t: DevTables, x: torch.Tensor, co: torch.Tensor, a_vec,
                 count: int | None = None, out: torch.Tensor | None = None,
                 co_out: torch.Tensor | None = None):
    """count (default len(a_vec)) squarings x^2 * a_k from the register x
    and its unit out-carries co, on the shapes of fourstep.chain_ok; returns
    (digits, unit out-carries), the state count square_steps leave. a_vec
    is a sequence of multipliers, or a CUDA int64 tensor of up to CHAIN_K
    of them (chain_multipliers builds one) that K9 reads as it stands."""
    if not tfs.chain_ok(t.fp):
        raise ValueError("square_chain needs a plan that fourstep.chain_ok "
                         "accepts (n = 2^15 ... 2^19, whole-row carries)")
    _check(t, (x, out), (co, co_out))
    if isinstance(a_vec, torch.Tensor):
        if a_vec.dtype != torch.int64 or a_vec.dim() != 1 or \
                not a_vec.is_contiguous() or a_vec.device != t.device or \
                a_vec.numel() > CHAIN_K:
            raise ValueError(f"the multiplier tensor must be contiguous 1-D "
                             f"int64 on {t.device}, at most {CHAIN_K} long")
        n_a = a_vec.numel()
    else:
        n_a = len(a_vec)
        a_vec = chain_multipliers(a_vec, t.device)
    count = n_a if count is None else int(count)
    if not 0 <= count <= n_a:
        raise ValueError(f"count={count} outside [0, {n_a}]")
    if _on_cpu(x):
        d, c = square_chain_plain(t, x, co, a_vec.tolist(), count)
        if out is not None:
            d = out.copy_(d)
        if co_out is not None:
            c = co_out.copy_(c)
        return d, c
    out = x.clone() if out is None else (out if out is x else out.copy_(x))
    co_out = co.clone() if co_out is None else \
        (co_out if co_out is co else co_out.copy_(co))
    if count == 0:
        return out, co_out
    err = _k9_launch(t, out, co_out, a_vec, count)
    calls["k9_chain"] += 1
    build.check(err, "k9_chain")
    return out, co_out


def square_chain_part(t: DevTables, x: torch.Tensor, co: torch.Tensor,
                      a: torch.Tensor, count: int, part: str = "full",
                      phases=K9_PHASES, form: str = "rule") -> None:
    """K9 for the pass profiler and the smoke's timing alone, in place on
    x and co, through its own entry point (csrc/k9_part.cu): "full" is the
    kernel, "move" its cut-down body (the same grid, tiles, loads, stores
    and grid barriers, an add for each product and no butterflies: it
    computes no chain, so no plain version exists); phases, all of
    K9_PHASES, none (the barriers alone) or one, runs those between the
    grid barriers (at L2 = 1 the row phase holds K2a and K2c, whose names
    then select nothing); form, with the full body and all phases, forces
    the row phase's "fused" or "split" form in place of the shape's rule.
    No counter moves. CUDA tensors and a multiplier tensor from
    chain_multipliers only."""
    phases = set(phases)
    whole = phases == set(K9_PHASES)
    if part not in K9_PARTS or form not in K9_FORMS or \
            not phases <= set(K9_PHASES) or \
            not (whole or len(phases) <= 1 and part == "full") or \
            not (form == "rule" or whole and part == "full"):
        raise ValueError((part, sorted(phases), form))
    if _on_cpu(x) or not tfs.chain_ok(t.fp):
        raise ValueError("square_chain_part: a chain_ok plan on the card")
    _check(t, (x,), (co,))
    if not 0 <= count <= a.numel():
        raise ValueError(f"count={count} outside [0, {a.numel()}]")
    mask = sum(1 << K9_PHASES.index(p) for p in phases)
    build.check(_k9_launch(t, x, co, a, count,
                           (K9_PARTS[part], mask, K9_FORMS[form])),
                f"k9_chain {part}")


# ---------------------------------------------------------------------------
# K4u / K5u: the unfolded r passes (kernels.py:130-375, :1530-1571)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class S8Tables:
    """A matrix (L, L), or one per variant (V, L, L), in the int8 form of
    the CUDA matrix form (ops/mxu_tables.py's device layout): w8 (V, kp,
    kp) int8 and corr (V, kp) int32, kp = 128 ceil(L / 16)."""
    w8: torch.Tensor
    corr: torch.Tensor
    L: int

    @property
    def kp(self) -> int:
        return self.w8.shape[-1]


def s8_tables(mats, device="cpu") -> S8Tables:
    """The int8 form of u64 matrices (numpy uint64, or an int64 tensor of
    their bit patterns), (L, L) or (V, L, L), built on the host
    (mxu_tables.tables_from_mats, device_layout)."""
    if isinstance(mats, torch.Tensor):
        mats = gl.to_numpy_u64(mats)
    m = np.asarray(mats, dtype=np.uint64)
    w8, corr = mxt.device_layout(*mxt.tables_from_mats(
        m.reshape((-1,) + m.shape[-2:])))
    return S8Tables(torch.from_numpy(w8).to(device),
                    torch.from_numpy(corr).to(device), m.shape[-1])


S8_MATS = ("tr_fwd", "d1i", "g2", "tri")


def s8_pack_model(x: torch.Tensor, kp: int) -> torch.Tensor:
    """The B operand of the matrix form (csrc/s8_dft.cuh's s8_pack_word):
    (L, B) words (u64 bit patterns in int64) -> (kp, B) int64, row c * 8 +
    l the int8 of byte l of word c XOR 0x80 (the byte less 128); the rows
    of padding words c >= L zero."""
    L, B = x.shape
    out = torch.zeros((kp // 8, 8, B), dtype=torch.int64, device=x.device)
    for l in range(8):
        out[:L, l] = ((x >> (8 * l)) & 0xFF) - 128
    return out.reshape(kp, B)


def s8_combine_model(d: torch.Tensor) -> torch.Tensor:
    """csrc/s8_dft.cuh's s8_combine in torch: planes d (8, ...) int64 in
    [0, 2^31) -> the lazy word gl_reduce128(lo, hi) of V = sum_m d_m
    2^(8m) = lo + hi 2^64, in 32-bit words held in int64; the same bits
    as the kernel's."""
    s0 = d[0] + (d[1] << 8) + (d[2] << 16) + (d[3] << 24)
    s1 = d[4] + (d[5] << 8) + (d[6] << 16) + (d[7] << 24)
    w1 = (s0 >> 32) + (s1 & gl.M32)
    lo0, lo1 = s0 & gl.M32, w1 & gl.M32
    hi = (s1 >> 32) + (w1 >> 32)
    # lo + hi (2^32 - 1), a wrap past 2^64 folded back as 2^32 - 1
    r0 = lo0 + ((-hi) & gl.M32)
    r1 = lo1 + hi - (hi > 0).to(torch.int64) + (r0 >> 32)
    r0 = (r0 & gl.M32) + (r1 >> 32) * gl.M32
    r1 = (r1 & gl.M32) + (r0 >> 32)
    return gl.join(r0 & gl.M32, r1)


def s8_dft_model(x: torch.Tensor, t: S8Tables, v: int = 0) -> torch.Tensor:
    """The matrix form's schedule on one variant v of the tables, for the
    tests: x (L, B) lazy words -> (L, B) lazy words = mats[v] @ x mod P.
    The byte planes (s8_pack_model), D = w8[v] @ X (exact in float64),
    + corr, each output's eight planes from the device rows (r >> 3) * 64
    + m * 8 + (r & 7), then s8_combine_model."""
    L, B = x.shape
    kp = t.kp
    X = s8_pack_model(x, kp)
    D = (t.w8[v].double() @ X.double()).to(torch.int64)
    d = D + t.corr[v].to(torch.int64).reshape(kp, 1)
    planes = d.reshape(kp // 64, 8, 8, B).permute(1, 0, 2, 3)
    return s8_combine_model(planes.reshape(8, kp // 8, B)[:, :L])


@dataclasses.dataclass(eq=False)
class UnfoldedView:
    """fourstep.UnfoldedTables on a device: the u64 tables as int64 bit
    patterns, cin_widths as int32; a matrix the JAX does not build is
    None. s8 holds each matrix's int8 form (S8Tables), by name."""
    w: torch.Tensor
    iw: torch.Tensor
    t_r: torch.Tensor
    t_r_inv: torch.Tensor
    mid: torch.Tensor
    mid_inv: torch.Tensor
    tr_fwd: torch.Tensor | None
    d1i: torch.Tensor | None
    g2: torch.Tensor | None
    tri: torch.Tensor | None
    cin_widths: torch.Tensor
    s8: dict

    @classmethod
    def from_host(cls, u: tfs.UnfoldedTables, device) -> "UnfoldedView":
        def put(name):
            a = getattr(u, name)
            if a is None:
                return None
            if name == "cin_widths":
                return torch.from_numpy(a.astype("int32")).to(device)
            return gl.from_numpy_u64(a, device)
        s8 = {name: s8_tables(getattr(u, name), device) for name in S8_MATS
              if getattr(u, name) is not None}
        return cls(**{f.name: put(f.name) for f in dataclasses.fields(cls)
                      if f.name != "s8"}, s8=s8)


def with_unfolded(t: DevTables,
                  u: tfs.UnfoldedTables | None = None) -> DevTables:
    """A copy of t that holds the unfolded view (built from t.fp unless u
    is given); t itself, and so an engine's cached tables, stay as they
    are."""
    if u is None:
        u = tfs.build_unfolded(t.fp)
    return dataclasses.replace(t, unfolded=UnfoldedView.from_host(
        u, t.device))


# The JAX tiles the lanes of an axis-0 pass once L * S * C reaches 2^22
# (kernels.py:262, AXIS0_BUDGET_EL), and then refuses the scalar injection
# (:280); the port refuses it at the same shapes.
AXIS0_BUDGET_EL = 1 << 22


def _axis0_lane_tiled(L: int, R2: int, C: int) -> bool:
    S = tfs._r2_tile(R2)
    return L * S * C >= AXIS0_BUDGET_EL and C % 256 == 0 and C > 256


def _check_pass(x, axis, pre, post, mats, cin, cin_widths, wcorr, out,
                s8=None):
    if x.dim() != 3 or x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("the register must be contiguous int64 "
                         f"(R1, R2, C) (got {x.dtype} {tuple(x.shape)})")
    if axis not in (0, 1):
        raise ValueError(f"axis {axis}: 0 (r1) or 1 (r2)")
    R1, R2, C = x.shape
    L = x.shape[axis]
    for name, a, shapes in (
            ("pre", pre, ((R1, R2, C), (R1, R2, 1))),
            ("post", post, ((R1, R2, C), (R1, R2, 1))),
            ("mats", mats, ((L, L), ((R2, R1)[axis], L, L))),
            ("out", out, ((R1, R2, C),))):
        if a is None:
            continue
        if a.dtype != torch.int64 or not a.is_contiguous() or \
                a.device != x.device or tuple(a.shape) not in shapes:
            raise ValueError(f"{name} must be contiguous int64 of shape "
                             f"{' or '.join(map(str, shapes))} on "
                             f"{x.device} (got {a.dtype} {tuple(a.shape)} "
                             f"on {a.device})")
    if mats is None and (L > 64 or 64 % L):
        raise ValueError(f"no shift-twiddle butterflies for L={L} (L must "
                         "divide 64): the pass needs its matrix")
    if s8 is not None:
        V = 1 if mats is None or mats.dim() == 2 else mats.shape[0]
        kp = mxt.padded(L)
        if mats is None or s8.L != L or \
                s8.w8.dtype != torch.int8 or \
                tuple(s8.w8.shape) != (V, kp, kp) or \
                s8.corr.dtype != torch.int32 or \
                tuple(s8.corr.shape) != (V, kp) or \
                not (s8.w8.is_contiguous() and s8.corr.is_contiguous()) or \
                s8.w8.device != x.device or s8.corr.device != x.device:
            raise ValueError(f"s8 must be the int8 form of mats: w8 int8 "
                             f"{(V, kp, kp)}, corr int32 {(V, kp)} on "
                             f"{x.device} (kernels.s8_tables(mats))")
    elif mats is not None and not _on_cpu(x):
        raise ValueError("the matrix form on the card takes the matrix's "
                         "int8 tables: s8=kernels.s8_tables(mats)")
    # the narrowest block's columns: axis_fft.cuh's (256 at L <= 8, else
    # 32) in the shift form, 32 in the matrix form
    cols = 256 if mats is None and L <= 8 else 32
    if C % cols:
        raise ValueError(f"C={C}: the {'shift' if mats is None else 'matrix'}"
                         f" form's blocks take C a multiple of {cols}")
    if axis == 1 and (cin is not None or wcorr is not None):
        raise ValueError("the axis-1 pass takes no injection and no wrap "
                         "correction (kernels.py:391)")
    if cin is not None:
        if not 0 <= cin < (1 << 64):
            raise ValueError(f"cin={cin} outside [0, 2^64)")
        if cin_widths is None or cin_widths.dtype != torch.int32 or \
                cin_widths.dim() != 1 or cin_widths.device != x.device or \
                not 0 < cin_widths.numel() <= C:
            raise ValueError("cin needs its widths: int32 (k,), k <= C, on "
                             "the register's device")
        if _axis0_lane_tiled(L, R2, C):
            raise ValueError("a lane-tiled axis-0 pass cannot carry the "
                             "injection strip (kernels.py:280)")
    if wcorr is not None:
        er, ec, _n = wcorr
        if er.dtype != torch.int32 or tuple(er.shape) != (R1, R2) or \
                ec.dtype != torch.int32 or tuple(ec.shape) != (C,) or \
                er.device != x.device or ec.device != x.device:
            raise ValueError("wcorr is (er int32 (R1, R2), ec int32 (C,), "
                             "n) on the register's device")


def cin_parts(cin: int, widths) -> list[int]:
    """The scalar carry spread base-2^width over the widths: the low 32
    bits of cin >> (the widths before), masked to its width but for the
    last part (kernels.py:189-206)."""
    parts, q = [], 0
    widths = [int(w) for w in widths]
    for j, w in enumerate(widths):
        part = (cin >> q) & gl.M32 if q < 64 else 0
        if j < len(widths) - 1:
            part &= (1 << w) - 1
        parts.append(part)
        q += w
    return parts


def _twiddles(exps, inverse: bool, like: torch.Tensor):
    """(lo, hi) of a level's twiddles 2^e (the inverse's 2^(96 - e), and 1
    at e = 0), shaped (1, m, 1...) against the level's (B, m, rest)
    halves."""
    m = len(exps)
    vals = [pow(2, (96 - e) if inverse and e else e, gl.P) for e in exps]
    sh = (1, m) + (1,) * (like.dim() - 2)
    return tuple(torch.tensor([f(v) for v in vals], dtype=torch.int64,
                              device=like.device).reshape(sh)
                 for f in (lambda v: v & gl.M32, lambda v: v >> 32))


def dft_shift_plain(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The length-L shift-twiddle DIF (or its mirrored DIT) along dim 0 of
    x (L, ...) (fourstep.py:339-389): per level of half-size m, a + b and
    (a - b) * 2^e; inverse, b * 2^(96 - e) and the swapped outputs at
    j > 0."""
    L = x.shape[0]
    levels = tfs.shift_exponents(L)
    if inverse:
        levels = levels[::-1]
    rest = tuple(x.shape[1:])
    x0, x1 = gl.split(x)
    for m, exps in levels:
        sh = (L // (2 * m), 2, m) + rest
        v0, v1 = x0.reshape(sh), x1.reshape(sh)
        a0, a1, b0, b1 = v0[:, 0], v1[:, 0], v0[:, 1], v1[:, 1]
        w0, w1 = _twiddles(exps, inverse, a0)
        if not inverse:
            s0, s1 = gl.add(a0, a1, b0, b1)
            d0, d1 = gl.mul(*gl.sub(a0, a1, b0, b1), w0, w1)
        else:
            bt = gl.mul(b0, b1, w0, w1)
            s0, s1 = gl.add(a0, a1, *bt)
            d0, d1 = gl.sub(a0, a1, *bt)
            if m > 1:
                first = torch.zeros((1, m) + (1,) * len(rest),
                                    dtype=torch.bool, device=x.device)
                first[:, 0] = True
                s0, d0 = torch.where(first, s0, d0), torch.where(first, d0, s0)
                s1, d1 = torch.where(first, s1, d1), torch.where(first, d1, s1)
        x0 = torch.stack([s0, d0], dim=1).reshape((L,) + rest)
        x1 = torch.stack([s1, d1], dim=1).reshape((L,) + rest)
    return gl.join(x0, x1)


def axis_pass_plain(x: torch.Tensor, axis: int, inverse: bool,
                    pre=None, post=None, mats=None, cin: int | None = None,
                    cin_widths=None, wcorr=None,
                    canon: bool = False, s8=None) -> torch.Tensor:
    """Plain K4u (axis 0, the length-R1 DFT over r1) or K5u (axis 1, over
    r2), in _pass_kernel's order: halve where wrapped (wcorr = (er, ec, n),
    not with canon), inject cin's parts into digits 0 ... k-1, x pre, the
    DFT (mats None: the shift butterflies; (L, L): one matrix; (V, L, L):
    one per r2 on axis 0, per r1 on axis 1), x post, and with canon the
    double where wrapped and the reduction to [0, P). s8, the kernel's
    int8 form of mats, is not read: the plain version multiplies by
    mats."""
    R1, R2, C = x.shape
    y = x
    mask = None
    if wcorr is not None:
        er, ec, n = wcorr
        mask = (er.to(torch.int64).reshape(R1, R2, 1)
                + ec.to(torch.int64).reshape(1, 1, C)) >= n
        if not canon:
            y = gl.join(*gl.halve_where(*gl.split(y), mask))
    if cin is not None:
        parts = cin_parts(cin, cin_widths.tolist())
        y = y.clone()
        y[0, 0, :len(parts)] += torch.tensor(parts, dtype=torch.int64,
                                             device=y.device)
    if pre is not None:
        y = gl.mulmod(y, pre)
    if axis == 1:
        y = y.permute(1, 0, 2)            # the transform axis first
    if mats is None:
        y = dft_shift_plain(y.contiguous(), inverse)
    else:
        # (L, V, C) with V the other axis: out[k, v, c] = sum_j
        # mats[v][k][j] * y[j, v, c] (or one matrix for every v)
        y = gl.matmul_mod(mats, y.permute(1, 0, 2)).permute(1, 0, 2)
    if axis == 1:
        y = y.permute(1, 0, 2)
    y = y.contiguous()
    if post is not None:
        y = gl.mulmod(y, post)
    if canon:
        y0, y1 = gl.split(y)
        if mask is not None:
            y0, y1 = gl.double_where(y0, y1, mask)
        y = gl.join(*gl.canon(y0, y1))
    return y


def axis_pass(x: torch.Tensor, axis: int, inverse: bool, pre=None,
              post=None, mats=None, cin: int | None = None, cin_widths=None,
              wcorr=None, canon: bool = False,
              out: torch.Tensor | None = None,
              s8: S8Tables | None = None) -> torch.Tensor:
    """K4u (axis 0) or K5u (axis 1) over the whole register, with the
    operands of axis_pass_plain; in place when out is x. On the card the
    matrix form takes mats' int8 form s8 (the unfolded view's s8[name],
    or s8_tables(mats)) and runs on the tensor cores; without mats, the
    shift form."""
    _check_pass(x, axis, pre, post, mats, cin, cin_widths, wcorr, out, s8)
    if _on_cpu(x):
        r = axis_pass_plain(x, axis, inverse, pre, post, mats, cin,
                            cin_widths, wcorr, canon)
        return r if out is None else out.copy_(r)
    R1, R2, C = x.shape
    if out is None:
        out = torch.empty_like(x)
    O, L, S = (1, R1, R2) if axis == 0 else (R1, R2, 1)
    var_o = int(mats is not None and mats.dim() == 3 and axis == 1)
    var_s = int(mats is not None and mats.dim() == 3 and axis == 0)
    er, ec, n = wcorr if wcorr is not None else (None, None, 0)
    w8, corr, kp = (s8.w8, s8.corr, s8.kp) if s8 else (None, None, 0)
    name = "k4u_pass" if axis == 0 else "k5u_pass"
    err = build.lib().prmers_k4u_pass(
        x.data_ptr(), out.data_ptr(), _ptr(pre),
        int(pre is not None and pre.shape[2] == 1), _ptr(post),
        int(post is not None and post.shape[2] == 1), _ptr(w8), _ptr(corr),
        kp, var_o, var_s, int(inverse), 0 if cin is None else cin,
        _ptr(cin_widths if cin is not None else None),
        0 if cin is None else cin_widths.numel(), _ptr(er), _ptr(ec), n,
        int(canon), O, L, S, C, _stream())
    calls[name] += 1
    build.check(err, name)
    return out


def _unfolded(t: DevTables) -> UnfoldedView:
    if t.unfolded is None:
        raise ValueError("the unfolded passes need the tables' unfolded "
                         "view: kernels.with_unfolded(t)")
    return t.unfolded


R_PASSES = ("k4u_fwd", "k5u_fwd", "k5u_inv", "k4u_inv")


def r_passes(t: DevTables, shift: bool, cin: int | None = None) -> dict:
    """The four unfolded passes of forward_r ("k4u_fwd", "k5u_fwd") and
    inverse_r ("k5u_inv", "k4u_inv"): name -> (axis, inverse, operands of
    axis_pass), in the matrix form, or with shift the butterflies on every
    factor (the JAX under PRMERS_NO_MXU)."""
    u = _unfolded(t)

    def mat(name):
        """mats and their int8 form s8, or none (the shift form)."""
        m = None if shift else getattr(u, name)
        return dict(mats=m, s8=None if m is None else u.s8[name])

    m1, m6 = mat("tr_fwd"), mat("tri")
    return {
        "k4u_fwd": (0, False, dict(
            pre=u.w, post=u.t_r if m1["mats"] is None else None, cin=cin,
            cin_widths=u.cin_widths if cin is not None else None, **m1)),
        "k5u_fwd": (1, False, dict(post=u.mid, **mat("g2"))),
        "k5u_inv": (1, True, dict(
            pre=u.mid_inv, post=u.t_r_inv if m6["mats"] is None else None,
            **m6)),
        "k4u_inv": (0, True, dict(post=u.iw, canon=True, **mat("d1i"))),
    }


def _run_passes(run, t: DevTables, x, names, cin, shift: bool):
    ps = r_passes(t, shift, cin)
    for name in names:
        axis, inverse, kw = ps[name]
        x = run(x, axis, inverse, **kw)
    return x


def forward_r(t: DevTables, x: torch.Tensor, cin: int | None = None,
              shift: bool = False) -> torch.Tensor:
    """The JAX `_forward_r` (kernels.py:1530-1550) without the weight fold:
    K4u (inject the scalar carry cin, x w, the r1 DFT: tr_fwd with t_r
    folded, or with shift the butterflies and then x t_r), then K5u (the
    r2 DFT, x mid). A factor the JAX builds no matrix for (fourstep.
    has_matrix) runs as butterflies in both forms; shift=True is the
    PRMERS_NO_MXU form, every factor as butterflies."""
    return _run_passes(axis_pass, t, x, R_PASSES[:2], cin, shift)


def forward_r_plain(t: DevTables, x: torch.Tensor, cin: int | None = None,
                    shift: bool = False) -> torch.Tensor:
    return _run_passes(axis_pass_plain, t, x, R_PASSES[:2], cin, shift)


def inverse_r(t: DevTables, z: torch.Tensor,
              shift: bool = False) -> torch.Tensor:
    """The JAX `_inverse_r` (kernels.py:1553-1571) without the weight fold:
    K5u (x mid_inv, the r2 inverse DFT: tr_inv with t_r_inv folded, or the
    butterflies and then x t_r_inv), then K4u (the r1 inverse DFT (L1,
    True) or the butterflies, x iw, canon); canonical out."""
    return _run_passes(axis_pass, t, z, R_PASSES[2:], None, shift)


def inverse_r_plain(t: DevTables, z: torch.Tensor,
                    shift: bool = False) -> torch.Tensor:
    return _run_passes(axis_pass_plain, t, z, R_PASSES[2:], None, shift)


# ---------------------------------------------------------------------------
# K10-K12: the fft3161 transform (csrc/f3_ntt.cu on f3_ntt.cuh)
# ---------------------------------------------------------------------------

def _f3_consts(inverse: bool) -> list:
    """w3 (root_unity(3) or its inverse) of each plane and the radix-4
    sign (ntt2._w4_is_i(q) == inverse), the reference's root family."""
    w31 = ntt2._w3_pair(ntt2.M31, inverse)
    w61 = ntt2._w3_pair(ntt2.M61, inverse)
    return [w31[0], w31[1], w61[0], w61[1],
            int(ntt2._w4_is_i(ntt2.M31) == inverse),
            int(ntt2._w4_is_i(ntt2.M61) == inverse)]


def _f3_check(t, x31, x61, words=()) -> None:
    """Planes (2, n) (M31 int32, M61 int64) and words (n,) int64, all
    contiguous on the tables' device."""
    n = t.n
    for x, dtype, shape in [(x31, torch.int32, (2, n)),
                            (x61, torch.int64, (2, n))] + \
            [(w, torch.int64, (n,)) for w in words]:
        if x.dtype != dtype or not x.is_contiguous() or \
                x.device != t.device or tuple(x.shape) != shape:
            raise ValueError(
                f"fft3161 operand must be contiguous {dtype} {shape} on "
                f"{t.device} (got {x.dtype} {tuple(x.shape)} on {x.device})")


def f3_fwd_args(t, i: int, x31, x61, d=None) -> list:
    """The C arguments of K10 (prmers_f3_fwd_stage, but the stream)."""
    st = t.stages[i]
    first = d is not None
    return [_ptr(x31), _ptr(x61), _ptr(st.tw31), _ptr(st.tw61),
            _ptr(t.w31) if first else None, _ptr(t.w61) if first else None,
            st.r, st.m, st.B, t.n, _ptr(d)] + _f3_consts(False)


def f3_inv_args(t, i: int, x31, x61, lo=None, hi=None) -> list:
    """The C arguments of K11 (prmers_f3_inv_stage, but the stream)."""
    st = t.stages[i]
    last = lo is not None
    return [_ptr(x31), _ptr(x61), _ptr(st.twi31), _ptr(st.twi61),
            _ptr(t.uw31) if last else None, _ptr(t.uw61) if last else None,
            st.r, st.m, st.B, t.n, _ptr(lo), _ptr(hi),
            ntt2.field2.Q31_INV_MOD_Q61] + _f3_consts(True)


def f3_fwd_stage(t, i: int, x31: torch.Tensor, x61: torch.Tensor,
                 d: torch.Tensor | None = None) -> None:
    """K10: forward stage i of both planes, in place (ntt2.plane_fwd's
    stage, :264-289); stage 0 takes the digits d (n,) instead of the
    planes and folds norm(d) x weights (forward_3161, :320-332)."""
    if (i == 0) != (d is not None):
        raise ValueError("the first forward stage, and only it, takes d")
    _f3_check(t, x31, x61, () if d is None else (d,))
    if _on_cpu(x61):
        y31, y61 = ntt2.fwd_stage_plain(t, i, x31, x61, d)
        x31.copy_(y31)
        x61.copy_(y61)
        return
    build.check(build.lib().prmers_f3_fwd_stage(
        *f3_fwd_args(t, i, x31, x61, d), _stream()), "f3_fwd_stage")
    calls["f3_fwd_stage"] += 1


def f3_inv_stage(t, i: int, x31: torch.Tensor, x61: torch.Tensor,
                 lo: torch.Tensor | None = None,
                 hi: torch.Tensor | None = None) -> None:
    """K11: inverse stage i of both planes, in place (ntt2.plane_inv's
    stage, :291-317); stage 0, the last, writes inverse_3161's exact
    coefficients (lo, hi) (n,) (:334-356) instead of the planes."""
    if (i == 0) != (lo is not None) or (lo is None) != (hi is None):
        raise ValueError("the last inverse stage, and only it, takes lo "
                         "and hi")
    _f3_check(t, x31, x61, () if lo is None else (lo, hi))
    if _on_cpu(x61):
        y = ntt2.inv_stage_plain(t, i, x31, x61)
        for dst, src in zip((lo, hi) if i == 0 else (x31, x61), y):
            dst.copy_(src)
        return
    build.check(build.lib().prmers_f3_inv_stage(
        *f3_inv_args(t, i, x31, x61, lo, hi), _stream()), "f3_inv_stage")
    calls["f3_inv_stage"] += 1


def f3_pointwise(t, x31: torch.Tensor, x61: torch.Tensor,
                 m31: torch.Tensor | None = None,
                 m61: torch.Tensor | None = None) -> None:
    """K12: the planes squared (Fq2Ops.sqr), or times a multiplicand's
    planes (m31, m61; Fq2Ops.mul), in place."""
    if (m31 is None) != (m61 is None):
        raise ValueError("a multiplicand has both planes")
    _f3_check(t, x31, x61)
    if m31 is not None:
        _f3_check(t, m31, m61)
    if _on_cpu(x61):
        y31, y61 = ntt2.pointwise_plain(x31, x61, m31, m61)
        x31.copy_(y31)
        x61.copy_(y61)
        return
    build.check(build.lib().prmers_f3_pointwise(
        _ptr(x31), _ptr(x61), _ptr(m31), _ptr(m61), t.n, _stream()),
        "f3_pointwise")
    calls["f3_pointwise"] += 1
