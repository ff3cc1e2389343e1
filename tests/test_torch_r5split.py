"""The 5 x 2^b split of the radix-5 r2 DFT (csrc/r2_split.cuh, the CUDA
form of K2's r2 launches and K5 at L2 = 5 * 2^b) on the CPU:

  * the split tables (fourstep.r2_split_tables) against big-int powers of
    root_554, at every L2 the port plans (5, 10, ..., 320);
  * its torch model (kernels.r2_split_plain) against the dense product
    that is the plain version (kernels.axis1_plain: "p2" with g2 and mf,
    "p6" with mi and tri), forward and inverse at every L2, on seeded
    lazy registers (R1, L2, C) = (3, L2, 8) whose row scales t_r_inv are
    three rows of a real plan's and whose mf, mi are seeded words;
  * the model at L2 = 320 against the JAX's _p2_pass / _p6_pass in
    interpret mode, their matrices built by the JAX's own
    mxu_dft.build_mxu_tables (the full JAX tables at L2 = 320 take a
    minute of CPU here; the passes read only these);
  * the kernel's per-column arithmetic (r5_dft5, r5_twiddle, r5_level,
    r5_row) built with the host's g++ (the header is host-callable, as
    gl64.cuh) against the dense DFT, forward and inverse at every L2.

Tolerance: none. Every comparison is exact mod P, after canon.
"""

import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from prmers_tpu_torch import convert
from prmers_tpu_torch.ops import fourstep as tfs
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import kernels as tk

GP = (1 << 64) - (1 << 32) + 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L2S = [5, 10, 20, 40, 80, 160, 320]
ROWS = (0, 9, 63)               # the r1 rows of t_r_inv the tests take
C = 8


def _t(a64):
    return tgl.from_numpy_u64(a64, "cpu")


def _t_r_inv_rows(L2: int) -> np.ndarray:
    """Rows ROWS of t_r_inv at the plan R = 64 * L2 (R1 = 64), in closed
    form: root_554(R)^(-freq1[r1] * k)."""
    R = 64 * L2
    rs = tfs.make_split(R)
    assert (rs.L1, rs.L2) == (64, L2)
    wR = tfs.root_554(R)
    return np.array([[pow(wR, -(int(rs.freq1[r]) * k) % R, GP)
                      for k in range(L2)] for r in ROWS], dtype=np.uint64)


def _tables(L2: int, rng) -> types.SimpleNamespace:
    """What axis1_plain and r2_split_plain read, on the CPU."""
    trs = _t_r_inv_rows(L2)
    split = tfs.r2_split_tables(L2, trs)
    R1 = len(ROWS)
    tabs = {k: torch.from_numpy(v) if k == "sh_exp" else _t(v)
            for k, v in split.items()}
    return types.SimpleNamespace(
        g2=_t(tfs.dft_matrix(L2, False)),
        tri=_t(tfs._fold_rows(tfs.dft_matrix(L2, True), trs)),
        mf=_t(rng.integers(0, GP, size=(R1, L2, C), dtype=np.uint64)),
        mi=_t(rng.integers(0, GP, size=(R1, L2, C), dtype=np.uint64)),
        **tabs)


@pytest.mark.parametrize("L2", L2S)
def test_split_tables_match_bigint(L2):
    """dft5 = W5^(+-k j) with W5 = w^M = root_554(5); the twiddles w^(+-k1
    j2) at k1 * M + j2; the shift exponents of the M-point DIF, and w^5 =
    root_554(M) = 2^(192 / M), the root those butterflies take."""
    M = L2 // 5
    w = tfs.root_554(L2)
    assert pow(w, M, GP) == tfs.root_554(5)
    assert pow(w, 5, GP) == tfs.root_554(M) == pow(2, 192 // M, GP)
    trs = _t_r_inv_rows(L2)
    sp = tfs.r2_split_tables(L2, trs)
    for inv, sgn in (("f", 1), ("i", -1)):
        d5 = [[pow(w, sgn * M * k * j % L2, GP) for j in range(5)]
              for k in range(5)]
        tw = [pow(w, sgn * k1 * j2 % L2, GP) for k1 in range(5)
              for j2 in range(M)]
        assert sp["dft5_" + inv].tolist() == d5
        assert sp["tw_" + inv].tolist() == tw
    want = [e for _m, es in tfs.shift_exponents(M) for e in es]
    assert sp["sh_exp"].dtype == np.int32 and sp["sh_exp"].tolist() == want
    assert len(want) == M - 1
    assert (sp["t_r_inv"] == trs).all()
    assert tfs.r2_split_tables(64, trs) is None


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("L2", L2S)
def test_split_model_matches_dense(L2, inverse):
    rng = np.random.default_rng(L2 + 1000 * inverse)
    t = _tables(L2, rng)
    x = _t(rng.integers(0, 1 << 64, size=(len(ROWS), L2, C),
                        dtype=np.uint64))
    got = tk.r2_split_plain(t, x, inverse)
    want = tk.axis1_plain(t, x, "p6" if inverse else "p2")
    assert torch.equal(tgl.canon64(got), tgl.canon64(want))


@pytest.mark.parametrize("part", sorted(tk.R5_PARTS))
def test_split_parts_refuse_the_cpu(part):
    """The split's cut-down bodies (the pass profiler's) compute no
    transform, so they have no plain version: on a CPU tensor the wrapper
    raises before it reaches the kernel library."""
    t = _tables(20, np.random.default_rng(20))
    x = _t(np.zeros((len(ROWS), 20, C), dtype=np.uint64))
    with pytest.raises(ValueError, match="on the card only"):
        tk.r2_split_part(t, x, "p2", part)


@pytest.mark.parametrize("which", ["p2", "p6"])
def test_split_model_matches_pallas_at_320(which, monkeypatch):
    """The JAX's P2 and P6 passes at L2 = 320 in interpret mode on the
    matrices its own build_mxu_tables makes: the natural-order DFT, and
    the inverse with the same t_r_inv rows folded in (the JAX's
    tr_inv)."""
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    import jax.numpy as jnp
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    from prmers_tpu.ops.pallas import mxu_dft as mx
    L2, Cj = 320, 128
    rng = np.random.default_rng(320)
    trs = _t_r_inv_rows(L2)
    R1 = len(ROWS)
    mf = rng.integers(0, GP, size=(R1, L2, Cj), dtype=np.uint64)
    mi = rng.integers(0, GP, size=(R1, L2, Cj), dtype=np.uint64)
    x = rng.integers(0, 1 << 64, size=(R1, L2, Cj), dtype=np.uint64)

    def table(w8, corr):
        mode = mx.lhs_bitcast_mode()
        return (mx.permute_lhs_cols_bytes(w8, mode) if mode else w8), corr

    def pair(a):
        return tuple(jnp.asarray(v) for v in convert.to_pairs(a))

    jt = types.SimpleNamespace(
        mxu={fs.mxu_key(L2, False): table(*mx.build_mxu_tables(L2, False)),
             "tr_inv": table(*mx.build_mxu_tables(L2, True,
                                                  row_scale=trs))},
        fused=(None,) + pair(mf) + pair(mi), t_r_inv=None)
    jfp = types.SimpleNamespace(rs=types.SimpleNamespace(L2=L2))
    f = kn._p2_pass if which == "p2" else kn._p6_pass
    r0, r1 = f(jfp, jt, *pair(x))
    split = {k: torch.from_numpy(v) if k == "sh_exp" else _t(v)
             for k, v in tfs.r2_split_tables(L2, trs).items()}
    t = types.SimpleNamespace(mf=_t(mf), mi=_t(mi), **split)
    mine = tk.r2_split_plain(t, _t(x), which == "p6")
    want = convert.from_pairs(np.asarray(r0), np.asarray(r1))
    assert (tgl.to_numpy_u64(tgl.canon64(mine)) ==
            tgl.to_numpy_u64(tgl.canon64(_t(want)))).all()


_HOST_MAIN = r"""
#include <stdio.h>
#include <vector>
#include "r2_split.cuh"

// stdin: L inverse ncols, dft5 (25), twiddles (L), shift exponents
// (M - 1), then the L x ncols values row by row; stdout: the split DFT of
// each column in natural order, row by row, as the kernel stores it.
int main() {
    int L, inv, nc;
    if (scanf("%d %d %d", &L, &inv, &nc) != 3) return 1;
    const int M = L / 5;
    int b = 0;
    while ((1 << b) < M) ++b;
    std::vector<u64> d5(25), tw(L), v((size_t)L * nc), out((size_t)L * nc);
    std::vector<int> ex(M > 1 ? M - 1 : 1);
    for (auto& w : d5) scanf("%llu", &w);
    for (auto& w : tw) scanf("%llu", &w);
    for (int i = 0; i < M - 1; ++i) scanf("%d", &ex[i]);
    for (auto& w : v) scanf("%llu", &w);
    for (int c = 0; c < nc; ++c) {
        u64* col = v.data() + c;
        for (int j2 = 0; j2 < M; ++j2) {
            r5_dft5(col + (long)j2 * nc, M * nc, d5.data());
            if (j2) r5_twiddle(col + (long)j2 * nc, M * nc, tw.data() + j2, M);
        }
        for (int lm = b - 1; lm >= 0; --lm)
            r5_level(col, nc, b, lm, ex.data() + (M - (2 << lm)), inv, 0, 1);
        for (int r = 0; r < L; ++r)
            out[(size_t)r5_row(r, b) * nc + c] = col[(size_t)r * nc];
    }
    for (auto w : out) printf("%llu\n", w);
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_split(tmp_path_factory):
    """csrc/r2_split.cuh's column functions built into a host program."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("r5split")
    src, exe = d / "main.cpp", d / "main"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I",
                    os.path.join(ROOT, "prmers_tpu_torch", "csrc"), str(src),
                    "-o", str(exe)], check=True, capture_output=True)
    return str(exe)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("L2", L2S)
def test_device_split_matches_dense(host_split, L2, inverse):
    """The kernel's column functions on lazy words (any u64) equal the
    dense natural-order DFT (dft_matrix, the JAX's) after canon."""
    rng = np.random.default_rng(7 * L2 + inverse)
    sp = tfs.r2_split_tables(L2, _t_r_inv_rows(L2))
    sfx = "i" if inverse else "f"
    x = rng.integers(0, 1 << 64, size=(L2, C), dtype=np.uint64)
    words = [L2, int(inverse), C] + sp["dft5_" + sfx].reshape(-1).tolist() \
        + sp["tw_" + sfx].tolist() + sp["sh_exp"].tolist() \
        + x.reshape(-1).tolist()
    r = subprocess.run([host_split], input="\n".join(map(str, words)),
                       capture_output=True, text=True, check=True)
    got = np.array([int(v) for v in r.stdout.split()],
                   dtype=np.uint64).reshape(L2, C)
    want = tgl.matmul_mod(_t(tfs.dft_matrix(L2, inverse)), _t(x))
    assert (tgl.to_numpy_u64(tgl.canon64(_t(got))) ==
            tgl.to_numpy_u64(tgl.canon64(want))).all()
