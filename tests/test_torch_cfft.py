"""The factored C-transform (csrc/fused_c_row.cuh, the CUDA row kernel of
K2, K6 and K6b) on the CPU:

  (a) its tables against big-int: the scales cs_f / cs_i
      (fourstep.fused_c_scales) with diag(cs_f[j]) @ V == Mf[j] and V^-1
      @ diag(cs_i[j]) == Mi[j] at every ca = 2 ... 64 (V the natural-order
      128-point DFT), and the 128-point schedule (fourstep.w128_shift,
      c_slot_schedule, lane_split);
  (b) its torch model (kernels.c_fft_plain) against the dense products
      that are the plain versions (fused_c_plain with r2fold off,
      fused_c_invh_plain), in modes sqr / mul / fwd and head ops sqr / mul
      / none, at every ca, on seeded lazy registers;
  (c) the model against the JAX's C-transform in Pallas interpret mode
      with the split forced (PRMERS_FC_SPLIT): K6 "fwd" (the spectral
      layout the stored multiplicand and the checkpoints carry) and the
      inverse half with each head op, at C = 256;
  (d) the header's row functions (c_row: the kernel's group steps in its
      order) built with the host's g++ against the dense product, forward
      and inverse at every C;
  (e) what the row kernel reads: neither the dense matrices nor a dense
      product, nor does K9's row phase, which runs the kernel's body.

Tolerance: none. Every comparison is exact mod P, after canon.
"""

import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from prmers_tpu_torch import convert
from prmers_tpu_torch.core.plan import build_plan
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk

GP = (1 << 64) - (1 << 32) + 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "prmers_tpu_torch", "csrc")
CAS = [2, 4, 8, 16, 32, 64]
ROWS = 3


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


def _plan(ca: int, R: int = 64) -> tfs.FourStepPlan:
    """A port plan of R rows of C = 128 * ca digits."""
    C = 128 * ca
    n = R * C
    plan = build_plan(int(n * 16.3) | 1, n=n)
    return tfs.FourStepPlan(p=plan.p, n=n, R=R, C=C, rs=tfs.make_split(R),
                            cs=tfs.make_split(C), widths=plan.widths,
                            max_word=plan.max_word)


def _row_tables(fp: tfs.FourStepPlan, rows: int) -> types.SimpleNamespace:
    """What the C-transform's plain versions and c_fft_plain read, for a
    (1, rows, C) register."""
    Mf, Mi, _wf, _wi = tfs.fused_c_mats(fp)
    cs_f, cs_i = tfs.fused_c_scales(fp)
    ca = fp.ca_count
    return types.SimpleNamespace(
        shape=(1, rows, fp.C), Mf=_t(Mf), Mi=_t(Mi), cs_f=_t(cs_f),
        cs_i=_t(cs_i), lane_f=_t(tfs.dft_matrix(ca, False)),
        lane_i=_t(tfs.dft_matrix(ca, True)))


def _v128(inverse: bool) -> np.ndarray:
    w = tfs.root_554(128)
    sgn = -1 if inverse else 1
    return np.array([[pow(w, sgn * l * k, GP) for k in range(128)]
                     for l in range(128)], dtype=np.uint64)


# ---------------------------------------------------------------------------
# (a) the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ca", CAS)
def test_scales_match_bigint(ca):
    """cs_f[j][l] = wcl[l] w_C^(l kl_j), cs_i[j][k] = iwcl[k] w_C^(-k
    kl_j) (kl_j = bitrev(j), wcl the weights' lane part), and the slot
    matrices factor exactly through them."""
    fp = _plan(ca)
    C, n = fp.C, fp.n
    cs_f, cs_i = tfs.fused_c_scales(fp)
    assert cs_f.shape == cs_i.shape == (ca, 128)
    assert cs_f.dtype == cs_i.dtype == np.uint64
    wC = tfs.root_554(C)
    nr2 = tfs.field.root_two_nth(n)
    pn = fp.p % n
    kl = tfs.dif_freq_of_pos(ca)
    for j in range(ca):
        for ll in range(0, 128, 9):
            wcl = pow(nr2, (-pn * ll) % n, GP)
            assert int(cs_f[j, ll]) == wcl * pow(wC, ll * int(kl[j]),
                                                 GP) % GP
            assert int(cs_i[j, ll]) == pow(wcl, -1, GP) * pow(
                wC, -ll * int(kl[j]), GP) % GP
    Mf, Mi, _wf, _wi = tfs.fused_c_mats(fp)
    assert (tfs.mulmod(cs_f[:, :, None], _v128(False)[None]) == Mf).all()
    assert (tfs.mulmod(_v128(True)[None], cs_i[:, None, :]) == Mi).all()


def test_w128_is_two_shifts():
    """w = root_554(128) = 2^73 - 2^25, w^2 = 8: every power of w is 2^s
    or 2^s (2^48 - 1) (w128_shift), s < 192."""
    w = tfs.root_554(128)
    assert w == (pow(2, 73, GP) - pow(2, 25, GP)) % GP
    assert pow(w, 2, GP) == 8
    for e in range(-128, 256):
        s, odd = tfs.w128_shift(e)
        assert 0 <= s < 192 and odd == (e % 2 == 1)
        assert pow(w, e % 128, GP) == pow(2, s, GP) * (
            (1 << 48) - 1 if odd else 1) % GP


def test_slot_schedule_matches_bigint():
    """The 16 x 8 schedule of the 128-point DFT: the sub-DFTs' shift
    exponents, the twiddle table t * bitrev4(m) and its shift form; run
    on big-int, the schedule is the natural-order DFT."""
    sch = tfs.c_slot_schedule()
    assert sch["dif16"] == tfs.shift_exponents(16)
    assert sch["dif8"] == tfs.shift_exponents(8)
    rev4 = tfs.dif_freq_of_pos(16)
    for t in range(8):
        for m in range(16):
            e = t * int(rev4[m])
            assert sch["tw"][t, m] == e
            assert (sch["shift"][t, m], sch["odd"][t, m]) == \
                tfs.w128_shift(e)
    assert sch["odd"].any() and not sch["odd"][0].any()
    w = tfs.root_554(128)
    rng = np.random.default_rng(128)
    x = [int(v) for v in rng.integers(0, GP, size=128, dtype=np.uint64)]

    def dif(v, L):
        """Radix-2 DIF by root_554(L) on big-int, as shift_exponents."""
        v = list(v)
        for m, exps in tfs.shift_exponents(L):
            for b in range(0, L, 2 * m):
                for jj in range(m):
                    a, c = v[b + jj], v[b + jj + m]
                    v[b + jj] = (a + c) % GP
                    v[b + jj + m] = (a - c) * pow(2, exps[jj], GP) % GP
        return v

    y = [0] * 128
    for t in range(8):
        col = dif([x[t + 8 * m] for m in range(16)], 16)
        for m in range(16):
            s, odd = int(sch["shift"][t, m]), bool(sch["odd"][t, m])
            y[t + 8 * m] = col[m] * pow(2, s, GP) * (
                (1 << 48) - 1 if odd else 1) % GP
    for h in range(16):
        y[8 * h:8 * h + 8] = dif(y[8 * h:8 * h + 8], 8)
    rev7 = tfs.dif_freq_of_pos(128)
    for pos in range(128):
        k = int(rev7[pos])
        assert y[pos] == sum(x[i] * pow(w, i * k, GP)
                             for i in range(128)) % GP


def test_lane_split_and_products():
    assert [tfs.lane_split(ca) for ca in CAS] == [
        (2, 1), (4, 1), (8, 1), (16, 1), (8, 4), (8, 8)]
    assert tfs.c_fft_products(8192) == 7.5
    assert tfs.c_fft_products(1024) == 6.0


# ---------------------------------------------------------------------------
# (b) the torch model against the dense plain versions
# ---------------------------------------------------------------------------

KINDS = {"k6-sqr": (True, "sqr", True), "k6-mul": (True, "mul", True),
         "k6-fwd": (True, "", False), "k6b-sqr": (False, "sqr", True),
         "k6b-mul": (False, "mul", True), "k6b-none": (False, "", True)}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("ca", CAS)
def test_model_matches_dense(ca, kind):
    fwd, op, inv = KINDS[kind]
    t = _row_tables(_plan(ca), ROWS)
    rng = np.random.default_rng(ca * 100 + list(KINDS).index(kind))
    x = _t(rng.integers(0, 1 << 64, size=t.shape, dtype=np.uint64))
    u = _t(rng.integers(0, 1 << 64, size=t.shape, dtype=np.uint64)) \
        if op == "mul" else None
    got = tk.c_fft_plain(t, x, fwd, op, inv, u)
    if fwd:
        want = tk.fused_c_plain(t, x, op or "fwd", u, r2fold=False)
    else:
        want = tk.fused_c_invh_plain(t, x, op, u)
    assert torch.equal(tgl.canon64(got), tgl.canon64(want))


@pytest.mark.parametrize("part", sorted(tk.C_PARTS))
def test_row_parts_refuse_the_cpu(part):
    """The row kernel's cut-down bodies (the pass profiler's) compute no
    transform, so they have no plain version: on a CPU tensor the wrapper
    raises before it reaches the kernel library."""
    t = _row_tables(_plan(16), 2)
    x = _t(np.zeros(t.shape, dtype=np.uint64))
    with pytest.raises(ValueError, match="on the card only"):
        tk.fused_c_part(t, x, part)


# ---------------------------------------------------------------------------
# (c) the model against the JAX's C-transform in interpret mode
# ---------------------------------------------------------------------------

JAX_SHAPES = {"c256": (1 << 14, 64, 256)}


@pytest.fixture(scope="module", params=list(JAX_SHAPES))
def jax_split(request):
    """A JAX and a port plan of one (R, C) split of n, the JAX tables and
    the port's, and seeded inputs."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PRMERS_PALLAS_INTERPRET", "1")
    mp.setenv("PRMERS_NO_CHAIN", "1")
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    n, R, C = JAX_SHAPES[request.param]
    p = int(n * 16.4) | 1
    plan = build_plan(p, n=n)
    jfp = fs.FourStepPlan(p=p, n=n, R=R, C=C, rs=fs.make_split(R),
                          cs=fs.make_split(C), widths=plan.widths,
                          max_word=plan.max_word)
    fp = tfs.FourStepPlan(p=p, n=n, R=R, C=C, rs=tfs.make_split(R),
                          cs=tfs.make_split(C), widths=plan.widths,
                          max_word=plan.max_word)
    jt = fs.FourStepTables.build(jfp, np, G=8, lanes=128)
    fs.attach_mxu_tables(jt)
    fs.attach_fused_c_tables(jt)
    t = tk.DevTables.from_host(tfs.build_tables(fp), "cpu")
    rng = np.random.default_rng(n + C)
    x = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    u = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    yield types.SimpleNamespace(jfp=jfp, jt=jt, kn=kn, t=t, x=x, u=u)
    mp.undo()


def _jpair(a64):
    import jax.numpy as jnp
    a0, a1 = convert.to_pairs(np.asarray(a64, dtype=np.uint64))
    return jnp.asarray(a0), jnp.asarray(a1)


def _force_split(js, monkeypatch):
    monkeypatch.setenv("PRMERS_FC_SPLIT", "1")
    assert js.kn._fc_split(js.jfp)


def test_model_fwd_matches_pallas(jax_split, monkeypatch):
    """K6 "fwd" of the split: the spectral layout, stage for stage."""
    js = jax_split
    _force_split(js, monkeypatch)
    r0, r1 = js.kn.fused_c_pass(js.jfp, js.jt, *_jpair(js.x), "fwd",
                                r2fold=False)
    mine = tk.c_fft_plain(js.t, _t(js.x), True, "", False)
    assert (_canon_np(_t(convert.from_pairs(r0, r1))) ==
            _canon_np(mine)).all()


@pytest.mark.parametrize("op", ["sqr", "mul", ""])
def test_model_invh_matches_pallas(jax_split, monkeypatch, op):
    """The inverse half (_fused_c_invh_kernel) with each head op, on a
    canonical spectral register."""
    js = jax_split
    _force_split(js, monkeypatch)
    ju = _jpair(js.u) if op == "mul" else None
    r0, r1 = js.kn.fused_c_pass(js.jfp, js.jt, *_jpair(js.x), "invh_" + op,
                                u=ju, r2fold=False)
    u = _t(js.u) if op == "mul" else None
    mine = tk.c_fft_plain(js.t, _t(js.x), False, op, True, u)
    assert (_canon_np(_t(convert.from_pairs(r0, r1))) ==
            _canon_np(mine)).all()


# ---------------------------------------------------------------------------
# (d) the header's row functions, built with g++
# ---------------------------------------------------------------------------

_HOST_MAIN = r"""
#include <stdio.h>
#include <vector>
#include "fused_c_row.cuh"

// stdin: lca inverse rows, the (C / 128, 128) scale table, then rows x C
// values; stdout: c_row of each row, row by row.
int main() {
    int lca, inv, rows;
    if (scanf("%d %d %d", &lca, &inv, &rows) != 3) return 1;
    const int C = 128 << lca;
    std::vector<u64> cs(C), x((size_t)rows * C);
    for (auto& w : cs) scanf("%llu", &w);
    for (auto& w : x) scanf("%llu", &w);
    for (int r = 0; r < rows; ++r)
        c_row(x.data() + (size_t)r * C, lca, cs.data(), inv);
    for (auto w : x) printf("%llu\n", w);
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    """csrc/fused_c_row.cuh's row functions built into a host program."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("cfft")
    src, exe = d / "main.cpp", d / "main"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", CSRC, str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    return str(exe)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("ca", CAS)
def test_device_rows_match_dense(host_rows, ca, inverse):
    """c_row on lazy words (any u64) equals the dense lane DFT and slot
    products (forward), or the slot products and inverse lane DFT, after
    canon."""
    fp = _plan(ca)
    t = _row_tables(fp, 2)
    cs = tgl.to_numpy_u64(t.cs_i if inverse else t.cs_f)
    rng = np.random.default_rng(10 * ca + inverse)
    x = rng.integers(0, 1 << 64, size=(2, fp.C), dtype=np.uint64)
    words = [ca.bit_length() - 1, int(inverse), 2] + cs.reshape(-1).tolist() \
        + x.reshape(-1).tolist()
    r = subprocess.run([host_rows], input="\n".join(map(str, words)),
                       capture_output=True, text=True, check=True)
    got = np.array([int(v) for v in r.stdout.split()], dtype=np.uint64)
    v = _t(x).reshape(1, 2, fp.C)
    if inverse:
        want = tk.fused_c_invh_plain(t, v, "")
    else:
        want = tk.fused_c_plain(t, v, "fwd", r2fold=False)
    assert (_canon_np(_t(got)) == _canon_np(want).reshape(-1)).all()


# ---------------------------------------------------------------------------
# (e) what the row kernel reads
# ---------------------------------------------------------------------------

def _function_body(text: str, name: str) -> str:
    """The source of the first definition of name (to its closing brace
    at column 0)."""
    i = text.index(name + "(")
    j = text.index("\n}\n", i)
    return text[i:j]


def test_row_kernel_reads_no_dense_table():
    """fused_c_row_kernel runs fused_c_row_group, which reads cs_f / cs_i
    only: no lane_f, lane_i, Mf, Mi and no dot-product accumulator; row_slot_mat, row_slot_unit and
    row_lane_dft are gone; the entry points of K2, K6 and K6b pass the
    scales; K9's row phase runs the kernel's body on cs_f, cs_i and
    names none of lane_f, lane_i, Mf, Mi."""
    with open(os.path.join(CSRC, "fused_c_row.cuh")) as f:
        row = f.read()
    kernel = _function_body(row, "fused_c_row_kernel")
    assert "fused_c_row_group<LCA, ROWS, PART>(" in kernel
    body = _function_body(row, "void fused_c_row_group")
    assert "cf_slot_a_fwd(" in body and "cf_slot_b_inv(" in body
    for word in ("lane_f", "lane_i", "Mf", "Mi", "gl_acc_madd", "GlAcc"):
        assert not re.search(r"\b%s\b" % word, body), word
    for name in ("row_slot_mat", "row_slot_unit", "row_lane_dft"):
        assert name not in row, name
    for src in ("k6_fused_c.cu", "k2_fused_c.cu"):
        with open(os.path.join(CSRC, src)) as f:
            text = f.read()
        assert "fused_c_rows(" in text
        for call in re.findall(r"fused_c_rows\([^;]*;", text):
            assert "cs_i" in call and not re.search(r"\bM[fi]\b", call)
    with open(os.path.join(CSRC, "k9_chain.cuh")) as f:
        k9 = f.read()
    assert "fused_c_row_group<" in k9
    assert "g.cs_f" in k9 and "g.cs_i" in k9
    for word in ("lane_f", "lane_i", "Mf", "Mi"):
        assert not re.search(r"\bg\.%s\b" % word, k9), word
