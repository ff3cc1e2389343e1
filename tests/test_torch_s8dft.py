"""The int8 matrix form of the unfolded passes (K4u / K5u) and the shape
probes' int8 product, held on the CPU:

  (a) the port's tables (ops/mxu_tables.py, the copied builders) equal the
      JAX's `build_mxu_tables` exactly, W8 and corr, and their device
      layout is W8's rows and columns permuted as ops/mxu_tables.py says,
      at L = 32, 64, 5, 40, 320, both directions, with and without row and
      column scales;
  (b) the torch model of the schedule (kernels.s8_dft_model: the byte
      planes, D = W8 @ X, + corr, the combine) equals the plain pass
      (kernels.axis_pass_plain, the u64 matrix) mod P on random lazy
      words, words >= P and 2^64 - 1 among them, and the JAX's
      `mxu_dft_apply` run under numpy (GL(np)) mod P;
  (c) csrc/s8_dft.cuh's s8_pack_word and s8_combine and csrc/s8_mma.cuh's
      s8_transpose4x4, built with the host's g++, equal the model bit for
      bit on worst-case planes at L = 320 (and at the combine's stated
      limit, 2^31 - 1);
  (d) what the wrappers hand the kernel library (a stand-in that
      records), and the shapes they refuse.

Tolerance: none; lazy words compare after canon where the two sides
reduce differently (the JAX's fold96 and the port's gl_reduce128).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from prmers_tpu.core.field import P as GP
from prmers_tpu.ops.pallas import gl64 as jgl
from prmers_tpu.ops.pallas import mxu_dft as jmx
from prmers_tpu_torch.ops import build
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk
from prmers_tpu_torch.ops import mxu_tables as mxt
from prmers_tpu_torch.ops import probes as pr

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "prmers_tpu_torch", "csrc")
LS = [32, 64, 5, 40, 320]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a64):
    return tgl.from_numpy_u64(np.asarray(a64, dtype=np.uint64), "cpu")


def _scales(L, kind, rng, K=2):
    rs = rng.integers(0, GP, size=(K, L), dtype=np.uint64)
    cs = rng.integers(0, GP, size=(K, L), dtype=np.uint64)
    return (rs, cs) if kind == "scaled" else (None, None)


def _device_order(W8, corr):
    """The device layout computed index by index from ops/mxu_tables.py's
    statement: row (r >> 3) * 64 + m * 8 + (r & 7), column c * 8 + l."""
    K, rows, _ = W8.shape
    L = rows // 8
    kp = 128 * -(-L // 16)
    Wd = np.zeros((K, kp, kp), dtype=np.int8)
    cd = np.zeros((K, kp), dtype=np.int32)
    r, m = np.meshgrid(np.arange(L), np.arange(8), indexing="ij")
    drow = ((r >> 3) * 64 + m * 8 + (r & 7)).reshape(-1)
    srow = (m * L + r).reshape(-1)
    c, l = np.meshgrid(np.arange(L), np.arange(8), indexing="ij")
    dcol = (c * 8 + l).reshape(-1)
    scol = (l * L + c).reshape(-1)
    Wd[:, drow[:, None], dcol[None, :]] = W8[:, srow[:, None], scol[None, :]]
    cd[:, drow] = corr.reshape(K, 8 * L)[:, srow]
    return Wd, cd


# ---------------------------------------------------------------------------
# (a) the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "scaled"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("L", LS)
def test_tables_equal_the_jax(L, inverse, kind):
    """build_mxu_tables equals the JAX's exactly; tables_from_mats on the
    port's own u64 matrix equals it too; the device layout is the stated
    permutation, zero-padded."""
    rng = np.random.default_rng(10 * L + inverse)
    rs, cs = _scales(L, kind, rng)
    jw, jc = jmx.build_mxu_tables(L, inverse, row_scale=rs, col_scale=cs)
    tw, tc = mxt.build_mxu_tables(L, inverse, row_scale=rs, col_scale=cs)
    assert tw.dtype == jw.dtype and tc.dtype == jc.dtype
    assert np.array_equal(tw, jw) and np.array_equal(tc, jc)
    M = tfs.dft_matrix(L, inverse)[None]
    if rs is not None:
        M = tfs.mulmod(tfs.mulmod(rs[:, :, None], M), cs[:, None, :])
    fw, fc = mxt.tables_from_mats(M)
    jw3, jc3 = jw.reshape(fw.shape), jc.reshape(fc.shape)
    assert np.array_equal(fw, jw3) and np.array_equal(fc, jc3)
    Wd, cd = mxt.device_layout(fw, fc)
    want_w, want_c = _device_order(jw3, jc3)
    assert np.array_equal(Wd, want_w) and np.array_equal(cd, want_c)
    s8 = tk.s8_tables(M)
    assert s8.L == L and s8.kp == mxt.padded(L)
    assert torch.equal(s8.w8, torch.from_numpy(want_w))
    assert torch.equal(s8.corr, torch.from_numpy(want_c))


# ---------------------------------------------------------------------------
# (b) the torch model of the schedule
# ---------------------------------------------------------------------------

def _lazy_words(rng, shape):
    x = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    flat = x.reshape(-1)
    flat[:4] = [(1 << 64) - 1, GP, GP + 1, 0]
    return x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("L", [5, 20, 32, 64, 320])
def test_model_equals_the_plain_pass(L, inverse):
    """s8_dft_model on each variant of the tables equals axis_pass_plain's
    K5u on the (R1, L, C) register with one matrix per r1, mod P."""
    R1, C = 3, 32
    rng = np.random.default_rng(L + 1000 * inverse)
    rs = rng.integers(0, GP, size=(R1, L), dtype=np.uint64)
    mats = tfs.mulmod(rs[:, :, None], tfs.dft_matrix(L, inverse)[None])
    x = _t(_lazy_words(rng, (R1, L, C)))
    want = tk.axis_pass_plain(x, 1, inverse, mats=_t(mats))
    s8 = tk.s8_tables(mats)
    for o in range(R1):
        got = tk.s8_dft_model(x[o], s8, o)
        assert torch.equal(tgl.canon64(got), tgl.canon64(want[o])), o


@pytest.mark.parametrize("L", [5, 32, 64, 320])
def test_model_equals_jax_mxu_dft_apply(L):
    """The JAX's mxu_dft_apply under GL(np) (its tables in its byte order)
    and the model on the port's tables: the same values mod P."""
    rng = np.random.default_rng(L)
    x = _lazy_words(rng, (L, 24))
    w8, corr = jmx.build_mxu_tables(L, False)
    mode = jmx.lhs_bitcast_mode()
    if mode:
        w8 = jmx.permute_lhs_cols_bytes(w8, mode)
    y0, y1 = jmx.mxu_dft_apply(jgl.GL(np), *jgl.to_pairs(x), L, w8, corr)
    want = jgl.from_pairs(np.asarray(y0), np.asarray(y1))
    got = tk.s8_dft_model(_t(x), tk.s8_tables(tfs.dft_matrix(L, False)))
    assert torch.equal(tgl.canon64(got), tgl.canon64(_t(want)))


def test_planes_stay_in_the_combines_range():
    """At L = 320 the worst-case planes reach 2^27 + 2560 * 127 * 255 + 255
    (< 2^28), past the reference's "< 2^27"; the model's planes on words
    of all-0x00 and all-0xFF bytes (the extremes of the bytes) stay in [0,
    2^28)."""
    L = 320
    s8 = tk.s8_tables(tfs.dft_matrix(L, True))
    off = mxt._plane_offset(8 * L)
    assert off == 1 << 27 and off + 8 * L * 127 * 255 + 255 < 1 << 28
    for fill in (0, (1 << 64) - 1):
        x = _t(np.full((L, 1), fill, dtype=np.uint64))
        X = tk.s8_pack_model(x, s8.kp)
        d = (s8.w8[0].double() @ X.double()).to(torch.int64) + \
            s8.corr[0].to(torch.int64).reshape(-1, 1)
        assert int(d.min()) >= 0 and int(d.max()) < 1 << 28


# ---------------------------------------------------------------------------
# (c) the headers' host-callable functions, built with g++
# ---------------------------------------------------------------------------

_HOST_MAIN = r"""
#include <cstdio>
#include "s8_dft.cuh"
#include "s8_mma.cuh"
// reads: op count, then the operands; writes one result a line
//   op 0: count x 8 planes -> s8_combine
//   op 1: count words -> s8_pack_word
//   op 2: count x 4 rows -> the four columns of s8_transpose4x4
int main() {
    int op, count;
    if (scanf("%d %d", &op, &count) != 2) return 1;
    for (int i = 0; i < count; ++i) {
        if (op == 0) {
            u32 d[8];
            for (int m = 0; m < 8; ++m) scanf("%u", &d[m]);
            printf("%llu\n", s8_combine(d));
        } else if (op == 1) {
            u64 w;
            scanf("%llu", &w);
            printf("%llu\n", s8_pack_word(w));
        } else {
            u32 r[4], c[4];
            for (int k = 0; k < 4; ++k) scanf("%u", &r[k]);
            s8_transpose4x4(r, c);
            for (int k = 0; k < 4; ++k) printf("%u\n", c[k]);
        }
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_s8(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("s8")
    src, exe = d / "main.cpp", d / "main"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", CSRC, str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    return str(exe)


def _run(exe, op, rows):
    words = [op, len(rows)] + [int(v) for r in rows for v in r]
    r = subprocess.run([exe], input="\n".join(map(str, words)),
                       capture_output=True, text=True, check=True)
    return [int(v) for v in r.stdout.split()]


# planes at L = 320 (contraction 2560, offset 2^27): the least and the
# most D + corr can be, each plane at either end, random ones between, and
# the combine's stated limit
_LO = (1 << 27) - 2560 * 128 * 255
_HI = (1 << 27) + 2560 * 127 * 255 + 255
PLANES = {"least": lambda rng: np.full((64, 8), _LO),
          "most": lambda rng: np.full((64, 8), _HI),
          "ends": lambda rng: np.where(rng.integers(0, 2, size=(64, 8)),
                                       _HI, _LO),
          "between": lambda rng: rng.integers(_LO, _HI + 1, size=(64, 8)),
          "limit": lambda rng: np.where(rng.integers(0, 2, size=(64, 8)),
                                        (1 << 31) - 1,
                                        rng.integers(0, 1 << 31,
                                                     size=(64, 8)))}


@pytest.mark.parametrize("case", list(PLANES))
def test_header_combine_equals_the_model(host_s8, case):
    rng = np.random.default_rng(len(case))
    d = PLANES[case](rng).astype(np.int64)
    got = np.array(_run(host_s8, 0, d.tolist()), dtype=np.uint64)
    want = tgl.to_numpy_u64(tk.s8_combine_model(torch.from_numpy(d.T)))
    assert np.array_equal(got, want)
    vals = [sum(int(v) << (8 * m) for m, v in enumerate(r)) % GP for r in d]
    assert [int(v) % GP for v in got] == vals


def test_header_pack_and_transpose(host_s8):
    """s8_pack_word's bytes, as int8, are the model's planes; the byte
    transpose is numpy's on 4 x 4 blocks."""
    rng = np.random.default_rng(4)
    w = _lazy_words(rng, (8, 1))
    got = np.array(_run(host_s8, 1, w.tolist()), dtype=np.uint64)
    want = tk.s8_pack_model(_t(w.T), 8).reshape(8, 8).numpy().T
    assert np.array_equal(got.view(np.int8).reshape(8, 8), want)
    rows = rng.integers(0, 1 << 32, size=(16, 4), dtype=np.uint64)
    cols = np.array(_run(host_s8, 2, rows.tolist()), dtype=np.uint64)
    b = rows.astype(np.uint32).view(np.uint8).reshape(16, 4, 4)
    want = np.ascontiguousarray(b.transpose(0, 2, 1)).view(np.uint32)
    assert np.array_equal(cols.astype(np.uint32), want.reshape(-1))


# ---------------------------------------------------------------------------
# (d) the wrappers
# ---------------------------------------------------------------------------

class _Recorder:
    """A stand-in for the kernel library: records each entry point's
    arguments and returns 0."""

    def __init__(self):
        self.args = {}

    def __getattr__(self, name):
        def fn(*args):
            self.args[name] = args
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    for mod in (tk, pr):
        monkeypatch.setattr(mod, "_on_cpu", lambda x: False)
        monkeypatch.setattr(mod, "_stream", lambda: 0)
        monkeypatch.setattr(mod, "calls", dict(mod.calls))
    monkeypatch.setattr(build, "lib", lambda: rec)
    return rec


def test_wrappers_hand_the_int8_tables(recorder):
    """The matrix form passes w8, corr and kp (never the u64 matrix), the
    shift form a null table; the dot its shape and fold; every call with
    as many arguments as its ctypes signature."""
    from prmers_tpu.core.plan import build_plan
    plan = build_plan(int((5 << 15) * 16.5) | 1, n=5 << 15)
    t = tk.with_unfolded(tk.DevTables.from_host(
        tfs.build_tables(tfs.FourStepPlan.from_plan(plan)), "cpu"))
    x = torch.zeros(t.shape, dtype=torch.int64)
    for name, (axis, inverse, kw) in tk.r_passes(t, False, 7).items():
        tk.axis_pass(x, axis, inverse, **kw)
        a = recorder.args["prmers_k4u_pass"]
        assert len(a) == len(build.SIGNATURES["prmers_k4u_pass"])
        s8 = kw["s8"]
        assert a[6:9] == (s8.w8.data_ptr(), s8.corr.data_ptr(), s8.kp), name
        assert kw["mats"].data_ptr() not in a
        var = kw["mats"].dim() == 3
        assert a[9:11] == (int(var and axis == 1), int(var and axis == 0))
    t15 = tk.with_unfolded(tk.DevTables.from_host(tfs.build_tables(
        tfs.FourStepPlan.from_plan(build_plan(540673, n=1 << 15))), "cpu"))
    x = torch.zeros(t15.shape, dtype=torch.int64)
    axis, inverse, kw = tk.r_passes(t15, True, None)["k5u_fwd"]
    tk.axis_pass(x, axis, inverse, **kw)
    assert recorder.args["prmers_k4u_pass"][6:9] == (None, None, 0)
    w = torch.zeros((576, 512), dtype=torch.int8)
    b = torch.zeros((512, 1024), dtype=torch.int8)
    for fold in (0, 64):
        out = pr.dot8(w, b, fold)
        a = recorder.args["prmers_probe_dot8"]
        assert len(a) == len(build.SIGNATURES["prmers_probe_dot8"])
        assert a[3:7] == (576, 1024, 512, fold)
        assert tuple(out.shape) == ((fold or 576), 1024)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((4, 40, 32), dtype=torch.int64)
    mats = _t(tfs.dft_matrix(40, False))
    s8 = tk.s8_tables(tfs.dft_matrix(40, False))
    assert tk.axis_pass(x, 1, False, mats=mats, s8=s8).shape == x.shape
    with pytest.raises(ValueError, match="int8 form"):
        tk.axis_pass(x, 1, False, mats=mats,
                     s8=tk.s8_tables(tfs.dft_matrix(32, False)))
    with pytest.raises(ValueError, match="int8 form"):     # no matrix
        tk.axis_pass(torch.zeros((4, 32, 32), dtype=torch.int64), 1, False,
                     s8=tk.s8_tables(tfs.dft_matrix(32, False)))
    bad = tk.S8Tables(s8.w8.to(torch.int32), s8.corr, 40)
    with pytest.raises(ValueError, match="int8 form"):
        tk.axis_pass(x, 1, False, mats=mats, s8=bad)
    with pytest.raises(ValueError, match="multiple of 32"):
        tk.axis_pass(torch.zeros((4, 40, 48), dtype=torch.int64), 1, False,
                     mats=mats, s8=s8)
    with pytest.raises(ValueError, match="multiple of 256"):
        tk.axis_pass(torch.zeros((4, 8, 128), dtype=torch.int64), 1, False)
    w = torch.zeros((64, 32), dtype=torch.int8)
    for args, what in (((w, torch.zeros((32, 24), dtype=torch.int8)), "16"),
                       ((w[:, :24].contiguous(),
                         torch.zeros((24, 16), dtype=torch.int8)), "16"),
                       ((w, torch.zeros((32, 16), dtype=torch.int8), 32),
                        "fold"),
                       ((w[:40].contiguous(),
                         torch.zeros((32, 16), dtype=torch.int8), 64),
                        "fold"),
                       ((w, torch.zeros((32, 16), dtype=torch.int32)),
                        "int8"),
                       ((w, torch.zeros((16, 32), dtype=torch.int8)),
                        "int8")):
        with pytest.raises(ValueError, match=what):
            pr.dot8(*args)
