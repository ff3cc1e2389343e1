"""The factored axis DFTs (csrc/axis_fft.cuh, the CUDA form of K1, of K2's
two r2 launches and of K5 at a power-of-two L2) on the CPU:

  (a) the factored tables against big-int: k1_cs / k1_rs with
      diag(k1_rs[:, s]) @ DFT_L1 @ diag(k1_cs[:, s]) == k1_mats[s] and
      diag(t_r_inv[o]) @ DFT_L2^-1 == tri[o], word for word, at n = 2^15,
      2^17 and 163840 (5 * 2^15), their entries in closed form, and the
      mesh's shard views of them;
  (b) the torch model of the schedule (kernels.axis_fft_model: two
      register passes around one exchange) against the dense dft_matrix
      product at every L = 1 ... 128, forward and inverse;
  (c) K1 and K5 (P2, P6) through the model (kernels.p1_carry_model,
      axis1_model) against the JAX's Pallas kernels in interpret mode:
      _p1c_kernel at n = 2^15 (L1 = 32) and on a (64, 16, 256) split of
      2^18 (L1 = 64), _p2_pass / _p6_pass on that split (L2 = 16), the
      port's pipeline forced onto K5 with Pipeline(r2fold_max);
  (d) the header's column functions (axf_dif_stride, axf_dit_stride with
      gl64.cuh's 8-point levels, in the kernel's order) built with the
      host's g++ against the dense product at every L, both ways;
  (e) what the K1, K5, K2, K3 and K4 wrappers hand the kernels: the
      scales, and no pointer to a dense matrix (k1_mats, g2, tri,
      k3_mats), read through a stand-in for the kernel library; and what
      the entry points include (K3a and K4 are held to their models in
      tests/test_torch_k3fft.py);
  (f) the move-only body's wrapper refuses CPU tensors.

Tolerance: none. Every comparison is exact mod P, after canon.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from prmers_tpu_torch import convert
from prmers_tpu_torch.core.plan import build_plan
from prmers_tpu_torch.ops import build
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk

GP = (1 << 64) - (1 << 32) + 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "prmers_tpu_torch", "csrc")
LS = [1, 2, 4, 8, 16, 32, 64, 128]
NS = {"2^15": 1 << 15, "2^17": 1 << 17, "5x2^15": 5 << 15}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a64):
    return tgl.from_numpy_u64(a64, "cpu")


def _canon_np(x):
    return tgl.to_numpy_u64(tgl.canon64(x))


def _plan(n: int):
    return build_plan(int(n * 16.5) | 1, n=n)


_KT = {}


def _kernel_tables(n: int) -> tfs.KernelTables:
    if n not in _KT:
        _KT[n] = tfs.build_tables(tfs.FourStepPlan.from_plan(_plan(n)))
    return _KT[n]


# ---------------------------------------------------------------------------
# (a) the factored tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", list(NS))
def test_factored_tables_match_bigint(size):
    """k1_mats and tri factor exactly through k1_cs, k1_rs and t_r_inv; the
    scales are wr (the weights' r-part), t_r and t_r_inv in closed form."""
    n = NS[size]
    kt = _kernel_tables(n)
    fp = kt.fp
    R1, R2, C = fp.shape
    R = fp.R
    assert kt.k1_cs.shape == kt.k1_rs.shape == kt.t_r_inv.shape == (R1, R2)
    for a in (kt.k1_cs, kt.k1_rs, kt.t_r_inv):
        assert a.dtype == np.uint64 and a.flags.c_contiguous
    d1 = tfs.dft_matrix(R1, False)
    for s in range(R2):
        want = tfs.mulmod(tfs.mulmod(kt.k1_rs[:, s, None], d1),
                          kt.k1_cs[None, :, s])
        assert (want == kt.k1_mats[s]).all(), s
    d2i = tfs.dft_matrix(R2, True)
    for o in range(R1):
        assert (tfs.mulmod(kt.t_r_inv[o, :, None], d2i) == kt.tri[o]).all()
    nr2 = tfs.field.root_two_nth(n)
    wR = tfs.root_554(R)
    pn = fp.p % n
    f1 = fp.rs.freq1
    for r1 in range(0, R1, 7):
        for r2 in range(0, R2, 3):
            e = (-pn * (r1 * R2 + r2) * C) % n
            assert int(kt.k1_cs[r1, r2]) == pow(nr2, e, GP)
            assert int(kt.k1_rs[r1, r2]) == pow(wR, int(f1[r1]) * r2 % R, GP)
            assert int(kt.t_r_inv[r1, r2]) == pow(
                wR, -(int(f1[r1]) * r2) % R, GP)


@pytest.mark.parametrize("s", [2, 4])
def test_shard_views_carry_the_scales(s):
    """The r2-sharded view keeps its part of k1_cs / k1_rs (axis 1), the
    r1-sharded one its part of t_r_inv (axis 0); K1 and K5 through the
    model on each rank's view equal the plain versions there."""
    kt = _kernel_tables(1 << 18)
    rng = np.random.default_rng(s)
    for rank in (0, s - 1):
        t2, t1 = (tk.DevTables.from_host(kt, "cpu", view, rank, s)
                  for view in (tk.R2_VIEW, tk.R1_VIEW))
        R1, R2 = kt.k1_cs.shape
        m2, m1 = R2 // s, R1 // s
        for name in ("k1_cs", "k1_rs"):
            assert (tgl.to_numpy_u64(getattr(t2, name)) ==
                    getattr(kt, name)[:, rank * m2:(rank + 1) * m2]).all()
        assert (tgl.to_numpy_u64(t1.t_r_inv) ==
                kt.t_r_inv[rank * m1:(rank + 1) * m1]).all()
        x = _t(rng.integers(0, 1 << 20, size=t2.shape, dtype=np.uint64))
        co = torch.from_numpy(rng.integers(0, 1 << 40,
                                           size=t2.row_carry_shape,
                                           dtype=np.int64))
        assert torch.equal(tgl.canon64(tk.p1_carry_model(t2, x, co)),
                           tgl.canon64(tk.p1_carry_plain(t2, x, co)))
        y = _t(rng.integers(0, 1 << 64, size=t1.shape, dtype=np.uint64))
        for which in ("p2", "p6"):
            assert torch.equal(tgl.canon64(tk.axis1_model(t1, y, which)),
                               tgl.canon64(tk.axis1_plain(t1, y, which)))


# ---------------------------------------------------------------------------
# (b) the model against the dense product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("L", LS)
def test_model_matches_dense(L, inverse):
    """axis_fft_model along dim 0 of lazy words (any u64) equals the dense
    DFT of fourstep.dft_matrix: DIF order out, and in for the inverse."""
    rng = np.random.default_rng(10 * L + inverse)
    x = _t(rng.integers(0, 1 << 64, size=(L, 15), dtype=np.uint64))
    want = tgl.matmul_mod(_t(tfs.dft_matrix(L, inverse)), x)
    got = tk.axis_fft_model(x.reshape(L, 3, 5), inverse).reshape(L, 15)
    assert torch.equal(tgl.canon64(got), tgl.canon64(want))


# ---------------------------------------------------------------------------
# (c) the model against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

SYN = (1 << 18, 1024, 256)       # n, R, C: (R1, R2, C) = (64, 16, 256)


@pytest.fixture(scope="module")
def jax_cases():
    """The JAX and the port's tables of n = 2^15 (its own plan) and of the
    (64, 16, 256) split of 2^18, the port's with K5 forced by
    Pipeline(r2fold_max), and seeded inputs."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PRMERS_PALLAS_INTERPRET", "1")
    mp.setenv("PRMERS_NO_CHAIN", "1")
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    cases = {}
    for name, (n, R, C) in (("2^15", (1 << 15, 32, 1024)), ("syn", SYN)):
        plan = _plan(n)
        jfp = fs.FourStepPlan(p=plan.p, n=n, R=R, C=C, rs=fs.make_split(R),
                              cs=fs.make_split(C), widths=plan.widths,
                              max_word=plan.max_word)
        fp = tfs.FourStepPlan(p=plan.p, n=n, R=R, C=C, rs=tfs.make_split(R),
                              cs=tfs.make_split(C), widths=plan.widths,
                              max_word=plan.max_word,
                              pipe=tfs.Pipeline(r2fold_max=2048))
        jt = fs.FourStepTables.build(jfp, np, G=8, lanes=128)
        fs.attach_mxu_tables(jt)
        fs.attach_fused_c_tables(jt)
        kn.attach_cinrow(jt)
        t = tk.DevTables.from_host(tfs.build_tables(fp), "cpu")
        rng = np.random.default_rng(n + R)
        mpw = (1 << plan.p) - 1
        v = int.from_bytes(rng.bytes(plan.p // 8 + 1), "little") % mpw
        from prmers_tpu_torch.utils import digits as dg
        x = dg.int_to_digits(v, plan.widths).reshape(t.shape)
        co = rng.integers(0, 1 << 40, size=t.carry_shape, dtype=np.uint64)
        z = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
        cases[name] = dict(jfp=jfp, jt=jt, t=t, x=x, co=co, z=z)
    yield kn, cases
    mp.undo()


def _jpair(a64):
    import jax.numpy as jnp
    a0, a1 = convert.to_pairs(np.asarray(a64, dtype=np.uint64))
    return jnp.asarray(a0), jnp.asarray(a1)


@pytest.mark.parametrize("case", ["2^15", "syn"])
def test_k1_model_matches_pallas(jax_cases, case):
    """_p1c_kernel (the JAX's K1, its carries rolled beforehand) against
    p1_carry_model on the port's unrolled carries."""
    kn, cases = jax_cases
    c = cases[case]
    t = c["t"]
    assert t.shape[0] == (32 if case == "2^15" else 64)
    rolled = np.roll(c["co"].reshape(-1), 1).reshape(c["co"].shape)
    (x0, x1), (c0, c1) = convert.state_to_jax(c["x"], rolled)
    import jax.numpy as jnp
    r0, r1 = kn.p1_carry_pass(c["jfp"], c["jt"], jnp.asarray(x0),
                              jnp.asarray(x1), jnp.asarray(c0),
                              jnp.asarray(c1))
    mine = tk.p1_carry_model(t, _t(c["x"]), _t(c["co"]))
    assert (_canon_np(_t(convert.from_pairs(r0, r1))) ==
            _canon_np(mine)).all()


@pytest.mark.parametrize("which", ["p2", "p6"])
def test_k5_model_matches_pallas(jax_cases, which):
    """_p2_pass / _p6_pass at L2 = 16 against axis1_model, where the
    port's pipeline takes K5 (the r2 passes do not fold into K2)."""
    kn, cases = jax_cases
    c = cases["syn"]
    t = c["t"]
    assert t.shape == (64, 16, 256)
    assert not tfs.use_r2fold(t.fp)
    f = kn._p2_pass if which == "p2" else kn._p6_pass
    r0, r1 = f(c["jfp"], c["jt"], *_jpair(c["z"]))
    mine = tk.axis1_model(t, _t(c["z"]), which)
    assert (_canon_np(_t(convert.from_pairs(r0, r1))) ==
            _canon_np(mine)).all()


# ---------------------------------------------------------------------------
# (d) the header's column functions, built with g++
# ---------------------------------------------------------------------------

_HOST_MAIN = r"""
#include <stdio.h>
#include <vector>
#include "axis_fft.cuh"

// The kernel's steps on one column of L = 2^LL words at stride nc: one
// register pass at L <= 8; else pass 1 on the values ty + 8t of each row
// ty, then pass 2 on each group of 8 (the inverse in the mirrored order).
template <int LL>
static void column(u64* col, int nc, int inv) {
    constexpr int L = 1 << LL;
    if constexpr (LL <= 3) {
        u64 v[L];
        for (int j = 0; j < L; ++j) v[j] = col[(long)j * nc];
        if (inv)
            gl_dit_shift_inv<LL>(v, 1);
        else
            gl_dif_shift<LL>(v, 1);
        for (int j = 0; j < L; ++j) col[(long)j * nc] = v[j];
    } else {
        constexpr int T = L / 8;
        u64 v[T], w[8];
        for (int step = 0; step < 2; ++step) {
            if ((step == 0) != (inv != 0)) {
                for (int ty = 0; ty < 8; ++ty) {
                    for (int t = 0; t < T; ++t) v[t] = col[(long)(ty + 8 * t) * nc];
                    if (inv)
                        axf_dit_stride<LL>(v, ty);
                    else
                        axf_dif_stride<LL>(v, ty);
                    for (int t = 0; t < T; ++t) col[(long)(ty + 8 * t) * nc] = v[t];
                }
            } else {
                for (int g = 0; g < T; ++g) {
                    for (int i = 0; i < 8; ++i) w[i] = col[(long)(8 * g + i) * nc];
                    if (inv)
                        gl_dit_shift_inv<3>(w, 1);
                    else
                        gl_dif_shift<3>(w, 1);
                    for (int i = 0; i < 8; ++i) col[(long)(8 * g + i) * nc] = w[i];
                }
            }
        }
    }
}

// stdin: LL inverse ncols, then the L x ncols values row by row; stdout:
// the transformed values, row by row.
int main() {
    int LL, inv, nc;
    if (scanf("%d %d %d", &LL, &inv, &nc) != 3) return 1;
    std::vector<u64> x((size_t)nc << LL);
    for (auto& w : x) scanf("%llu", &w);
    for (int c = 0; c < nc; ++c) {
        u64* col = x.data() + c;
        switch (LL) {
        case 0: column<0>(col, nc, inv); break;
        case 1: column<1>(col, nc, inv); break;
        case 2: column<2>(col, nc, inv); break;
        case 3: column<3>(col, nc, inv); break;
        case 4: column<4>(col, nc, inv); break;
        case 5: column<5>(col, nc, inv); break;
        case 6: column<6>(col, nc, inv); break;
        case 7: column<7>(col, nc, inv); break;
        default: return 2;
        }
    }
    for (auto w : x) printf("%llu\n", w);
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_columns(tmp_path_factory):
    """csrc/axis_fft.cuh's column functions built into a host program."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("axisfft")
    src, exe = d / "main.cpp", d / "main"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", CSRC, str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    return str(exe)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("L", LS)
def test_device_columns_match_dense(host_columns, L, inverse):
    """The kernel's column functions on lazy words (any u64) equal the
    dense DFT after canon: a wrong index map would put right values at
    wrong positions."""
    nc = 4
    rng = np.random.default_rng(100 * L + inverse)
    x = rng.integers(0, 1 << 64, size=(L, nc), dtype=np.uint64)
    words = [L.bit_length() - 1, int(inverse), nc] + x.reshape(-1).tolist()
    r = subprocess.run([host_columns], input="\n".join(map(str, words)),
                       capture_output=True, text=True, check=True)
    got = np.array([int(v) for v in r.stdout.split()],
                   dtype=np.uint64).reshape(L, nc)
    want = tgl.matmul_mod(_t(tfs.dft_matrix(L, inverse)), _t(x))
    assert (_canon_np(_t(got)) == _canon_np(want)).all()


# ---------------------------------------------------------------------------
# (e) what the wrappers hand the kernels
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
    """The wrappers as they run on a CUDA tensor, on CPU tensors: _on_cpu
    says no, the library records instead of launching."""
    rec = _Recorder()
    monkeypatch.setattr(tk, "_on_cpu", lambda x: False)
    monkeypatch.setattr(tk, "_stream", lambda: 0)
    monkeypatch.setattr(build, "lib", lambda: rec)
    monkeypatch.setattr(tk, "calls", dict(tk.calls))
    return rec


@pytest.mark.parametrize("size", list(NS))
def test_wrappers_pass_no_dense_matrix(recorder, size):
    """K1 and K4 forward pass k1_cs and k1_rs, K3 and K4 inverse k3_rs, K5
    (P2, P6) and K2 mf / mi and t_r_inv; none of them a pointer to
    k1_mats, g2, tri or k3_mats."""
    t = tk.DevTables.from_host(_kernel_tables(NS[size]), "cpu")
    x = torch.zeros(t.shape, dtype=torch.int64)
    co = torch.zeros(t.row_carry_shape, dtype=torch.int64)
    dense = {t.k1_mats.data_ptr(), t.g2.data_ptr(), t.tri.data_ptr(),
             t.k3_mats.data_ptr()}
    tk.p1_carry_pass(t, x, co)
    k1 = recorder.args["prmers_k1_p1c"]
    assert t.k1_cs.data_ptr() in k1 and t.k1_rs.data_ptr() in k1
    for which in ("p2", "p6"):
        tk.axis1_pass(t, x, which)
        k5 = recorder.args["prmers_k5_axis1"]
        assert t.t_r_inv.data_ptr() in k5
        assert (t.mi if which == "p6" else t.mf).data_ptr() in k5
        assert not dense & set(k5), which
    tk.fused_c_pass(t, x, "sqr")
    k2 = recorder.args["prmers_k2_fused_c"]
    assert {t.mf.data_ptr(), t.mi.data_ptr(), t.t_r_inv.data_ptr()} <= \
        set(k2)
    assert not dense & set(k1) and not dense & set(k2)
    tk.p7_carry_pass(t, x, a=3)
    k3 = recorder.args["prmers_k3_p7c"]
    assert t.k3_rs.data_ptr() in k3 and not dense & set(k3)
    bco = torch.zeros(t.block_carry_shape, dtype=torch.int64)
    for inverse, co, scales in ((False, bco, (t.k1_cs, t.k1_rs)),
                                (False, None, (t.k1_cs, t.k1_rs)),
                                (True, None, (t.k3_rs,))):
        tk.axis0_pass(t, x, inverse, co=co)
        k4 = recorder.args["prmers_k4_axis0"]
        assert {a.data_ptr() for a in scales} <= set(k4), inverse
        assert not dense & set(k4), inverse
    for name in ("prmers_k1_p1c", "prmers_k5_axis1", "prmers_k2_fused_c",
                 "prmers_k3_p7c", "prmers_k4_axis0"):
        assert len(recorder.args[name]) == len(build.SIGNATURES[name])


def _function_body(text: str, name: str) -> str:
    """The source of the first definition of name (to its closing brace
    at column 0)."""
    i = text.index(name + "(")
    j = text.index("\n}\n", i)
    return text[i:j]


def test_entry_points_run_the_shift_form():
    """The K1, K5, K2, K3 and K4 entry points launch axis_fft.cuh at a
    power-of-two length (K3 its own one launch on axis_fft.cuh's inverse
    tile) and take no matrix; the tile the kernel runs
    (and all after it) has no dot-product accumulator; axis_dft.cuh has no launcher and no tile left, and K9
    runs axis_fft.cuh's tile in its four axis phases."""
    def read(name):
        with open(os.path.join(CSRC, name)) as f:
            return f.read()
    fft = read("axis_fft.cuh")
    tile = fft[fft.index("void axis_fft_tile("):]
    kernel = _function_body(fft, "axis_fft_kernel")
    assert "axis_fft_tile<MODE, LL, PART>(" in kernel
    for word in ("gl_acc_madd", "GlAcc", "mats"):
        assert not re.search(r"\b%s\b" % word, tile), word
    for src, entry in (("k1_p1c.cu", "prmers_k1_p1c"),
                       ("k5_axis1.cu", "prmers_k5_axis1"),
                       ("k2_fused_c.cu", "prmers_k2_fused_c"),
                       ("k3_p7c.cu", "prmers_k3_p7c"),
                       ("k4_axis0.cu", "prmers_k4_axis0")):
        body = _function_body(read(src), entry)
        launch = "k3_launch_rounds<" if entry == "prmers_k3_p7c" else \
            "axis_fft_launch<"
        assert launch in body and "axis_dft_launch" not in body
        for word in ("mats", "g2", "tri", "k1_mats", "k3_mats"):
            assert not re.search(r"\b%s\b" % word, body), (src, word)
    assert "axf_inv_values<AX_K3A, LL, AXF_FULL>" in read("k3_p7c.cu")
    k4 = read("k4_axis0.cu")
    assert "axis_fft_launch<AX_K3A>" in k4 and "axis_fft_launch<AX_K4F>" in k4
    dft = read("axis_dft.cuh")
    assert "axis_dft_launch" not in dft and "axis_dft_tile" not in dft
    for src in os.listdir(CSRC):
        assert "axis_dft_launch" not in read(src)
        assert "axis_dft_tile" not in read(src)
    k9 = read("k9_chain.cuh")
    for mode in ("AX_K1", "AX_K2A", "AX_K2C", "AX_K3A"):
        assert f"axis_fft_tile<{mode}," in k9


# ---------------------------------------------------------------------------
# (f) the move-only body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", sorted(tk.AXIS_MOVES))
def test_move_body_refuses_the_cpu(which):
    """The move-only body computes no transform and has no plain version:
    on a CPU tensor its wrapper raises before it reaches the library."""
    t = tk.DevTables.from_host(_kernel_tables(1 << 15), "cpu")
    x = torch.zeros(t.shape, dtype=torch.int64)
    with pytest.raises(ValueError, match="on the card only"):
        tk.axis_fft_move(t, x, which)
