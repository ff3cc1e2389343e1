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
mode "fwd"; K3 two; the others one).

  K1  p1_carry_pass         csrc/k1_p1c.cu      carry inject, wrap halve,
                                                r1 DFT
  K2  fused_c_pass          csrc/k2_fused_c.cu  r2 DFT x mf, C-transform
      (r2fold)                                  with the mode, mirror
  K3  p7_carry_pass         csrc/k3_p7c.cu      r1 inverse DFT, double,
                                                canon, x a or + (M_p - 2),
                                                carry per unit
  K5  axis1_pass            csrc/k5_axis1.cu    P2 (r2 DFT x mf) or P6
                                                (x mi, r2 inverse) alone
  K6  fused_c_pass          csrc/k6_fused_c.cu  the C-transform with the
      (r2fold off)                              mode, no r2 passes
  K6b fused_c_invh_pass     csrc/k6_fused_c.cu  head op, inverse half of
                                                the C-transform
  K9  square_chain          csrc/k9_chain.cu    up to CHAIN_K squarings
                                                x^2 * a_k in one persistent
                                                launch (n = 2^15 ... 2^19)
  K4  axis0_pass            csrc/k4_axis0.cu    forward: block-carry inject,
                                                wrap halve, r1 DFT; inverse:
                                                r1 inverse, double, canon
  K7  block_carry_pass      csrc/k7_block_carry.cu  x a, the carry ripple
                                                over each r1 block, block
                                                out-carries
  K8  block_carry_local     csrc/k7_block_carry.cu  K7's kernel with K8's
                                                round rule, on a rank's
                                                r1 blocks (the mesh)
  K4u axis_pass, axis 0     csrc/k4u_pass.cu    the unfolded r passes:
  K5u axis_pass, axis 1                         [halve], [inject], [x pre],
                                                DFT (matrix or shift
                                                butterflies), [x post],
                                                [double, canon]

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
reference.

The radix-5 plans (n = 5 * 2^k, R2 = L2 = 5 * 2^b up to 320) go through
the same wrappers: no wrapper, plain version or kernel other than the r2
DFT needs a power-of-two R2. K1, K3's first launch and K4 take R2 as the
grid's r2 extent, K3b, K7 and the row kernel count rows or units of it,
and the r2 DFT (K2a/K2c, K5) reads its natural-order matrices from the
tables (ops/fourstep.dft_matrix); at L2 = 160 and 320 the CUDA launch
takes csrc/axis_dft.cuh's global-matrix form. K9 never runs there
(fourstep.chain_ok asks for a power-of-two L2, as the JAX does).

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

KERNELS = ("k1_p1c", "k2_fused_c", "k3_p7c", "k5_axis1", "k6_fused_c",
           "k6b_fused_c_invh", "k9_chain", "k4_axis0", "k7_block_carry",
           "k8_local", "k4u_pass", "k5u_pass")
SOURCES = {
    "k1_p1c": "prmers_tpu_torch/csrc/k1_p1c.cu",
    "k2_fused_c": "prmers_tpu_torch/csrc/k2_fused_c.cu",
    "k3_p7c": "prmers_tpu_torch/csrc/k3_p7c.cu",
    "k5_axis1": "prmers_tpu_torch/csrc/k5_axis1.cu",
    "k6_fused_c": "prmers_tpu_torch/csrc/k6_fused_c.cu",
    "k6b_fused_c_invh": "prmers_tpu_torch/csrc/k6_fused_c.cu",
    "k9_chain": "prmers_tpu_torch/csrc/k9_chain.cu",
    "k4_axis0": "prmers_tpu_torch/csrc/k4_axis0.cu",
    "k7_block_carry": "prmers_tpu_torch/csrc/k7_block_carry.cu",
    "k8_local": "prmers_tpu_torch/csrc/k7_block_carry.cu",
    "k4u_pass": "prmers_tpu_torch/csrc/k4u_pass.cu",
    "k5u_pass": "prmers_tpu_torch/csrc/k4u_pass.cu",
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
}
calls = {name: 0 for name in KERNELS}

MODES = {"sqr": 0, "mul": 1, "fwd": 2}
CHAIN_K = 512           # K9's multiplier-buffer extent (kernels.py:1916)
HEAD_OPS = {"": 0, "sqr": 1, "mul": 2}


def reset_calls() -> None:
    for name in KERNELS:
        calls[name] = 0


_U64_TABLES = ("k1_mats", "g2", "mf", "mi", "lane_f", "lane_i", "Mf", "Mi",
               "tri", "k3_mats")
_I32_TABLES = ("er", "ec", "wt", "cum", "widths", "bwt", "bcum")

# The shard views of the mesh (sharded_pallas.py:92-136): each table a view
# keeps, with the axis cut to the rank's part (None: kept whole). Tables a
# view leaves out are None in it, so a kernel given the wrong view fails.
# The r2-sharded view serves K1, K3 and K4 on (R1, R2/s, C); the
# r1-sharded one K5, K6, K6b and K8 on (R1/s, R2, C).
R2_VIEW = {"k1_mats": 0, "k3_mats": 0, "er": 1, "ec": None, "wt": 1,
           "cum": 1, "widths": 1}
R1_VIEW = {"g2": None, "mf": 0, "mi": 0, "lane_f": None, "lane_i": None,
           "Mf": None, "Mi": None, "tri": 0, "ec": None, "widths": 0,
           "bwt": 0, "bcum": 0}


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
    unfolded: "UnfoldedView | None" = None

    @classmethod
    def from_host(cls, kt: tfs.KernelTables, device, view: dict | None = None,
                  rank: int = 0, s: int = 1) -> "DevTables":
        """The tables on device; with a view (R2_VIEW, R1_VIEW), rank's
        shard of them for s ranks, each cut table one contiguous copy."""
        tabs = {}
        for name in _U64_TABLES + _I32_TABLES:
            a = getattr(kt, name)
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


def p1_carry_plain(t: DevTables, x: torch.Tensor,
                   co: torch.Tensor) -> torch.Tensor:
    """Plain K1: inject the rolled unit carries, halve where wrapped, then
    the per-r2 folded r1 DFT."""
    k = t.k
    parts = inject_parts(roll_row_carries(co), t.wt, t.cum)
    xu = _units(t, x)
    head = xu[..., :k] + parts           # digits < 2^32: no u64 wrap
    y = torch.cat([head, xu[..., k:]], dim=-1).reshape(t.shape)
    return _p1_dft(t, y)


def _p1_dft(t: DevTables, y: torch.Tensor) -> torch.Tensor:
    """Halve where wrapped, then the per-r2 folded r1 DFT: K1 and K4
    forward after their injections."""
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
        t.fp.n, t.k1_mats.data_ptr(), R1, R2, C, _stream())
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


def axis1_pass(t: DevTables, x: torch.Tensor, which: str,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """K5: P2 or P6 over the whole register (kernels.py:1574-1594)."""
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
    err = build.lib().prmers_k5_axis1(
        x.data_ptr(), out.data_ptr(),
        (t.tri if inverse else t.g2).data_ptr(),
        (t.mi if inverse else t.mf).data_ptr(), int(inverse), R1, R2, C,
        _stream())
    calls["k5_axis1"] += 1
    build.check(err, "k5_axis1")
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
        err = lib.prmers_k2_fused_c(
            x.data_ptr(), out.data_ptr(), _ptr(u), MODES[mode],
            t.g2.data_ptr(), t.mf.data_ptr(), t.lane_f.data_ptr(),
            t.lane_i.data_ptr(), t.Mf.data_ptr(), t.Mi.data_ptr(),
            t.mi.data_ptr(), t.tri.data_ptr(), R1, R2, C, _stream())
    else:
        name = "k6_fused_c"
        err = lib.prmers_k6_fused_c(
            x.data_ptr(), out.data_ptr(), _ptr(u), MODES[mode],
            t.lane_f.data_ptr(), t.lane_i.data_ptr(), t.Mf.data_ptr(),
            t.Mi.data_ptr(), R1 * R2, C, _stream())
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
        t.lane_i.data_ptr(), t.Mi.data_ptr(), R1 * R2, C, _stream())
    calls["k6b_fused_c_invh"] += 1
    build.check(err, "k6b_fused_c_invh")
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
    y0, y1 = gl.canon(*gl.double_where(*gl.split(y), _wrap_mask(t)))
    if a != 1:
        y0, y1 = gl.canon(*gl.mul_small(y0, y1, a))
    return gl.join(y0, y1)


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


def p7_carry_pass(t: DevTables, x: torch.Tensor, a: int = 1,
                  sub2: bool = False, out: torch.Tensor | None = None,
                  co_out: torch.Tensor | None = None, s2: int = 2):
    """K3 on the C-transform's output: returns (digits, unit out-carries
    (R1, R2, T)). With sub2, s2 is what comes off the register's digit 0:
    2, or 0 on a mesh rank that does not hold global digit 0
    (sharded_pallas.py:493-498)."""
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
        t.k3_mats.data_ptr(), t.er.data_ptr(), t.ec.data_ptr(), t.fp.n,
        t.widths.data_ptr(), t.rounds, a, int(a != 1), int(sub2), s2,
        R1, R2, C, t.ct, _stream())
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


def axis0_pass(t: DevTables, x: torch.Tensor, inverse: bool,
               co: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """K4: P1 (with the unrolled (R1, 1) block carries co injected, when
    given) or P7 (kernels.py:1619-1639) over the whole register."""
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
        t.ec.data_ptr(), t.fp.n,
        (t.k3_mats if inverse else t.k1_mats).data_ptr(), R1, R2, C,
        _stream())
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
    R1, R2, C = t.shape
    scratch = torch.empty_like(out)
    err = build.lib().prmers_k9_chain(
        out.data_ptr(), co_out.data_ptr(), scratch.data_ptr(),
        a_vec.data_ptr(), count,
        t.k1_mats.data_ptr(), t.wt.data_ptr(), t.cum.data_ptr(), t.k,
        t.er.data_ptr(), t.ec.data_ptr(), t.fp.n, t.g2.data_ptr(),
        t.mf.data_ptr(), t.lane_f.data_ptr(), t.lane_i.data_ptr(),
        t.Mf.data_ptr(), t.Mi.data_ptr(), t.mi.data_ptr(), t.tri.data_ptr(),
        t.k3_mats.data_ptr(), t.widths.data_ptr(), t.rounds, R1, R2, C,
        _stream())
    calls["k9_chain"] += 1
    build.check(err, "k9_chain")
    return out, co_out


# ---------------------------------------------------------------------------
# K4u / K5u: the unfolded r passes (kernels.py:130-375, :1530-1571)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class UnfoldedView:
    """fourstep.UnfoldedTables on a device: the u64 tables as int64 bit
    patterns, cin_widths as int32; a matrix the JAX does not build is
    None."""
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

    @classmethod
    def from_host(cls, u: tfs.UnfoldedTables, device) -> "UnfoldedView":
        def put(name):
            a = getattr(u, name)
            if a is None:
                return None
            if name == "cin_widths":
                return torch.from_numpy(a.astype("int32")).to(device)
            return gl.from_numpy_u64(a, device)
        return cls(**{f.name: put(f.name) for f in dataclasses.fields(cls)})


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


def _check_pass(x, axis, pre, post, mats, cin, cin_widths, wcorr, out):
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
                    canon: bool = False) -> torch.Tensor:
    """Plain K4u (axis 0, the length-R1 DFT over r1) or K5u (axis 1, over
    r2), in _pass_kernel's order: halve where wrapped (wcorr = (er, ec, n),
    not with canon), inject cin's parts into digits 0 ... k-1, x pre, the
    DFT (mats None: the shift butterflies; (L, L): one matrix; (V, L, L):
    one per r2 on axis 0, per r1 on axis 1), x post, and with canon the
    double where wrapped and the reduction to [0, P)."""
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
              out: torch.Tensor | None = None) -> torch.Tensor:
    """K4u (axis 0) or K5u (axis 1) over the whole register, with the
    operands of axis_pass_plain; in place when out is x."""
    _check_pass(x, axis, pre, post, mats, cin, cin_widths, wcorr, out)
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
    name = "k4u_pass" if axis == 0 else "k5u_pass"
    err = build.lib().prmers_k4u_pass(
        x.data_ptr(), out.data_ptr(), _ptr(pre),
        int(pre is not None and pre.shape[2] == 1), _ptr(post),
        int(post is not None and post.shape[2] == 1), _ptr(mats), var_o,
        var_s, int(inverse), 0 if cin is None else cin,
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
    m1 = None if shift else u.tr_fwd
    m6 = None if shift else u.tri
    return {
        "k4u_fwd": (0, False, dict(
            pre=u.w, post=u.t_r if m1 is None else None, mats=m1, cin=cin,
            cin_widths=u.cin_widths if cin is not None else None)),
        "k5u_fwd": (1, False, dict(post=u.mid,
                                   mats=None if shift else u.g2)),
        "k5u_inv": (1, True, dict(
            pre=u.mid_inv, post=u.t_r_inv if m6 is None else None,
            mats=m6)),
        "k4u_inv": (0, True, dict(post=u.iw, mats=None if shift else u.d1i,
                                  canon=True)),
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
