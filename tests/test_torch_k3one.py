"""K3 in one launch (csrc/k3_p7c.cu: the r1 inverse DFT and the row carry,
each tile's edge carries handed to the next tile) on the CPU:

  (a) the header's row carry (csrc/k3_tile.cuh: k3_row_carry with
      k3_split, k3_round, k3_last and k3_sub2_add), built with the host's
      g++ and run tile by tile in the kernel's schedule (tiles of 32
      digits of a row in ticket order; the rounds with zeros in give a
      tile's edge words, the rounds again with the tile before's words in
      give its digits; a unit's first tile takes zeros, its last writes
      the out-carry), against carry_plain at rounds = 2 ... 6 on canonical
      words near 2^64 (and P - 1), with and without sub2 (s2 = 2 and 0),
      at T = 1, T = 4 and on the radix-5 (64, 10, 256) split; and the edge
      words a tile computes with zeros in equal those it leaves with its
      predecessor's words in (the order's premise);
  (b) the torch model of the one launch (kernels.p7_carry_model: the
      inverse by p7_dft_model, then carry_tiles_model) against
      p7_carry_plain at 2^15 and 2^17 (T = 1), 2^17 with T = 2
      (Pipeline(carry_max)), the radix-5 (64, 10, 256) split and the
      mesh's r2-sharded view at s = 2 (s2 = 0 on the last rank), a = 1
      and 3, with and without sub2; and against the JAX's p7_carry_pass
      (_p7c_kernel in interpret mode) at 2^15 and on the radix-5 split;
  (c) the scratch: made once with the tables K3 reads, of
      k3_scratch_words, on the shard views too; what the entry point
      launches (one kernel, no second carry launch) and the header
      constants the wrapper sizes the scratch by.

Tolerance: none. Digits and unit carries are compared bit for bit.
"""

import dataclasses
import os
import re
import shutil
import subprocess

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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a64):
    return tgl.from_numpy_u64(np.asarray(a64, dtype=np.uint64), "cpu")


def _np(x):
    return tgl.to_numpy_u64(x)


def _split_plan(n: int, R: int, C: int) -> tfs.FourStepPlan:
    plan = build_plan(int(n * 16.5) | 1, n=n)
    return tfs.FourStepPlan(p=plan.p, n=n, R=R, C=C, rs=tfs.make_split(R),
                            cs=tfs.make_split(C), widths=plan.widths,
                            max_word=plan.max_word)


def _plan(n: int, pipe=tfs.Pipeline()) -> tfs.FourStepPlan:
    return tfs.FourStepPlan.from_plan(build_plan(int(n * 16.5) | 1, n=n),
                                      pipe)


# the plans: n = 2^15 (32, 1, 1024) and 2^17 (64, 2, 1024) whole rows,
# 2^17 with T = 2 and T = 4 carry units, the radix-5 (64, 10, 256) split
# of 5 * 2^15, and 2^18 (64, 4, 1024) for the mesh's r2 views
PLANS = {
    "2^15": lambda: _plan(1 << 15),
    "2^17": lambda: _plan(1 << 17),
    "2^17-t2": lambda: _plan(1 << 17, tfs.Pipeline(carry_max=1 << 16)),
    "2^17-t4": lambda: _plan(1 << 17, tfs.Pipeline(carry_max=1 << 14)),
    "r5": lambda: _split_plan(5 << 15, 640, 256),
    "2^18": lambda: _plan(1 << 18),
}
_KT = {}


def _kernel_tables(key) -> tfs.KernelTables:
    if key not in _KT:
        _KT[key] = tfs.build_tables(PLANS[key]())
    return _KT[key]


def _tables(key, view=None, rank=0, s=1) -> tk.DevTables:
    return tk.DevTables.from_host(_kernel_tables(key), "cpu", view, rank, s)


def _near_top(rng, shape):
    """Canonical words, most near 2^64 (P - 2^40 ... P), some uniform, and
    P - 1 every 97th: the split's widest carries."""
    y = rng.integers(GP - (1 << 40), GP, size=shape, dtype=np.uint64)
    low = rng.random(shape) < 0.25
    y[low] = rng.integers(0, GP, size=int(low.sum()), dtype=np.uint64)
    y.reshape(-1)[::97] = GP - 1
    return y


# ---------------------------------------------------------------------------
# (a) the header's row carry, built with g++
# ---------------------------------------------------------------------------

_HOST_MAIN = r"""
#include <stdio.h>
#include <vector>
#include "k3_tile.cuh"

// The one launch's carry on the host, tile by tile in ticket order.
// stdin: seven int64 (L1, S, C, ct, rounds, sub2, s2), then the L1*S*C
// values (u64) and their widths (u32). stdout: the digits (u64), the unit
// out-carries (u64), then one u64: 1 if every tile's edge words with the
// tile before's words in equal those it computed with zeros in.
int main() {
    long long h[7];
    if (fread(h, sizeof h, 1, stdin) != 1) return 1;
    const int L1 = (int)h[0], S = (int)h[1], C = (int)h[2], ct = (int)h[3];
    const int rounds = (int)h[4], sub2 = (int)h[5];
    const u64 s2 = (u64)h[6];
    const size_t n = (size_t)L1 * S * C;
    std::vector<u64> x(n);
    std::vector<u32> w(n);
    if (fread(x.data(), 8, n, stdin) != n) return 1;
    if (fread(w.data(), 4, n, stdin) != n) return 1;
    if (sub2)
        for (size_t i = 0; i < n; ++i) x[i] += k3_sub2_add(w[i], i == 0, s2);
    const int NB = C / K3_TW, tpu = ct / K3_TW, R = rounds + 1;
    const int ntiles = S * NB, units = C / ct;
    std::vector<u64> edge((size_t)ntiles * L1 * R);
    std::vector<u64> co((size_t)L1 * S * units), tmp(K3_TW), chk(R);
    u64 same = 1;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int s = tile / NB, cb = tile % NB, pos = cb % tpu;
        for (int k = 0; k < L1; ++k) {
            const size_t at = ((size_t)k * S + s) * C + (size_t)cb * K3_TW;
            u64* e = &edge[((size_t)tile * L1 + k) * R];
            // a: zeros in, the edge words out
            for (int l = 0; l < K3_TW; ++l) tmp[l] = x[at + l];
            const u64 acc = k3_row_carry(tmp.data(), 1, &w[at], 1, K3_TW,
                                         rounds, nullptr, e);
            if (pos == tpu - 1)
                co[((size_t)k * S + s) * units + cb / tpu] = acc;
            if (pos == 0) {
                for (int l = 0; l < K3_TW; ++l) x[at + l] = tmp[l];
                continue;
            }
            // c: the tile before's words in
            const u64* cin = &edge[((size_t)(tile - 1) * L1 + k) * R];
            k3_row_carry(&x[at], 1, &w[at], 1, K3_TW, rounds, cin,
                         chk.data());
            for (int r = 0; r < R; ++r) same &= chk[r] == e[r];
        }
    }
    fwrite(x.data(), 8, n, stdout);
    fwrite(co.data(), 8, co.size(), stdout);
    fwrite(&same, 8, 1, stdout);
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_carry(tmp_path_factory):
    """csrc/k3_tile.cuh's row carry built into a host program."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("k3tile")
    src, exe = d / "main.cpp", d / "main"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", CSRC, str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    return str(exe)


def _run_host(exe, t, y, sub2, s2):
    R1, R2, C = t.shape
    head = np.array([R1, R2, C, t.ct, t.rounds, int(sub2), s2],
                    dtype=np.int64)
    w = _np(t.widths.to(torch.int64)).astype(np.uint32)
    out = subprocess.run([exe], input=head.tobytes() + y.tobytes() +
                         w.tobytes(), check=True, capture_output=True).stdout
    words = np.frombuffer(out, dtype=np.uint64)
    n, units = y.size, R1 * R2 * (C // t.ct)
    assert words.size == n + units + 1
    return (words[:n].reshape(t.shape), words[n:n + units].reshape(
        t.row_carry_shape), int(words[-1]))


@pytest.mark.parametrize("rounds", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("key", ["2^15", "2^17-t4", "r5"])
def test_host_row_carry_matches_plain(host_carry, key, rounds):
    """k3_row_carry tile by tile equals carry_plain (digits and unit
    carries) at a forced round count, plain and with sub2 (s2 = 2, and 0
    as on a mesh rank without digit 0); every tile's edge words are the
    same with zeros in and with the tile before's words in."""
    t = dataclasses.replace(_tables(key), rounds=rounds)
    assert t.ct >= 8 * tk.K3_TW
    rng = np.random.default_rng(100 * rounds + len(key))
    y = _near_top(rng, t.shape)
    for sub2, s2 in ((False, 2), (True, 2), (True, 0)):
        d, co, same = _run_host(host_carry, t, y, sub2, s2)
        dw, cw = tk.carry_plain(t, _t(y), sub2, s2)
        assert (d == _np(dw)).all(), (sub2, s2)
        assert (co == _np(cw)).all(), (sub2, s2)
        assert same == 1, (sub2, s2)


def test_edge_words_need_nothing_from_the_tile_before(host_carry):
    """A tile whose predecessor leaves large carries: its digits change,
    its edge words do not (so a tile publishes before it waits), and a
    unit's first tile takes zeros: units do not leak into each other."""
    t = _tables("2^17-t4")
    rng = np.random.default_rng(5)
    y = _near_top(rng, t.shape)
    d0, co0, same = _run_host(host_carry, t, y, False, 0)
    assert same == 1
    y2 = y.copy()
    y2[:, :, 31] = GP - 1                # the last digit of tile 0
    y2[:, :, t.ct - 1] = GP - 1          # the last digit of unit 0
    d2, co2, same = _run_host(host_carry, t, y2, False, 0)
    assert same == 1
    assert (d2[:, :, 32:33] != d0[:, :, 32:33]).any()   # tile 1 moved
    # unit 1 (from digit ct) is untouched: unit 0's carry leaves as co
    assert (d2[:, :, t.ct:] == d0[:, :, t.ct:]).all()
    assert (co2[:, :, 1:] == co0[:, :, 1:]).all()
    assert (co2[:, :, 0] != co0[:, :, 0]).any()


# ---------------------------------------------------------------------------
# (b) the torch model of the one launch
# ---------------------------------------------------------------------------

MODEL_CASES = ["2^15", "2^17", "2^17-t2", "r5", "mesh-0", "mesh-1"]


def _model_tables(case):
    if case.startswith("mesh"):
        rank = int(case[-1])
        return _tables("2^18", tk.R2_VIEW, rank, 2), (2 if rank == 0 else 0)
    return _tables(case), 2


@pytest.mark.parametrize("case", MODEL_CASES)
def test_model_matches_plain(case):
    """p7_carry_model equals p7_carry_plain bit for bit, digits and unit
    carries, on lazy words (any u64) as the C-transform leaves them, with
    a = 1 and 3, with and without sub2 (the rank's s2 on the mesh view)."""
    t, s2 = _model_tables(case)
    if case == "2^17-t2":
        assert t.row_carry_shape[2] == 2
    if case.startswith("mesh"):
        assert t.shape == (64, 2, 1024)
    rng = np.random.default_rng(len(case) + 7)
    z = _t(rng.integers(0, 1 << 64, size=t.shape, dtype=np.uint64))
    for a in (1, 3):
        for sub2 in (False, True):
            d, co = tk.p7_carry_model(t, z, a, sub2, s2)
            dw, cw = tk.p7_carry_plain(t, z, a, sub2, s2)
            assert torch.equal(d, dw), (a, sub2)
            assert torch.equal(co, cw), (a, sub2)


@pytest.mark.parametrize("key", ["2^15", "r5"])
def test_model_matches_pallas(monkeypatch, key):
    """The one launch's model against the JAX's p7_carry_pass
    (_p7c_kernel in interpret mode) on the same seeded residues: a = 3, and
    sub2 with a = 1; digits and unit carries."""
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PRMERS_NO_CHAIN", "1")
    import jax.numpy as jnp
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    fp = _kernel_tables(key).fp
    jfp = fs.FourStepPlan(p=fp.p, n=fp.n, R=fp.R, C=fp.C,
                          rs=fs.make_split(fp.R), cs=fs.make_split(fp.C),
                          widths=fp.widths, max_word=fp.max_word)
    jt = fs.FourStepTables.build(jfp, np, G=8, lanes=128)
    fs.attach_mxu_tables(jt)
    fs.attach_fused_c_tables(jt)
    kn.attach_cinrow(jt)
    t = _tables(key)
    rng = np.random.default_rng(fp.n)
    z = rng.integers(0, GP, size=t.shape, dtype=np.uint64)
    z.reshape(-1)[::97] = GP - 1
    a0, a1 = convert.to_pairs(z)
    for a, sub2 in ((3, False), (1, True)):
        d, co = tk.p7_carry_model(t, _t(z), a, sub2)
        ap = (jnp.full((1, 1), np.uint32(a)), jnp.zeros((1, 1), jnp.uint32))
        d0, d1, c0, c1 = kn.p7_carry_pass(jfp, jt, jnp.asarray(a0),
                                          jnp.asarray(a1), ap, a == 1,
                                          sub2=sub2 or None)
        x2, co2 = convert.state_from_jax(d0, d1, c0, c1)
        assert (x2 == _np(d)).all() and (co2 == _np(co)).all(), (a, sub2)


# ---------------------------------------------------------------------------
# (c) the scratch and the entry point
# ---------------------------------------------------------------------------

def test_scratch_made_once_with_the_tables():
    """DevTables.from_host makes K3's scratch, zeros of k3_scratch_words,
    wherever the tables hold k3_rs: whole and on the r2-sharded view (the
    shard's shape), not on the r1-sharded one, which K3 never takes; the
    engines' copies of the tables share it."""
    t = _tables("2^17")
    assert t.k3_scratch.numel() == tk.k3_scratch_words(t.shape, t.rounds)
    R1, R2, C = t.shape
    assert t.k3_scratch.numel() == \
        4 + R2 * C // 32 * (1 + R1 * (t.rounds + 1))
    assert not t.k3_scratch.any()
    assert dataclasses.replace(t, fp=t.fp).k3_scratch is t.k3_scratch
    t2 = _tables("2^18", tk.R2_VIEW, 1, 2)
    assert t2.k3_scratch.numel() == tk.k3_scratch_words(t2.shape, t2.rounds)
    assert _tables("2^18", tk.R1_VIEW, 1, 2).k3_scratch is None


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _code(text):
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def test_entry_point_is_one_launch():
    """prmers_k3_p7c launches k3_kernel once (one instantiation a L1 and
    round count) and nothing else: no axis_fft_launch, no second carry kernel; the kernel
    runs the inverse tile and the header's steps, and the constants the
    wrapper sizes the scratch by are the kernel's."""
    code = _code(_read("k3_p7c.cu"))
    entry = code[code.index('extern "C" int prmers_k3_p7c('):]
    assert len(re.findall(r"k3_launch_rounds<\d>\(", entry)) == 2
    assert len(re.findall(r"<<<", code)) == 1
    for word in ("axis_fft_launch", "k3b_unit", "k3b_kernel", "cudaMemset"):
        assert word not in code, word
    kernel = code[code.index("k3_kernel(K3Args k) {"):]
    for step in ("axf_inv_values<AX_K3A", "axf_post<AX_K3A", "k3_split(",
                 "k3_sub2_add(", "k3_rounds_out<T, RND>(",
                 "k3_rounds_in<T, RND>(", "k3_st_release(",
                 "k3_ld_acquire(", "atomicAdd("):
        assert step in kernel, step
    assert re.search(r"#define K3_HDR (\d+)", code).group(1) == \
        str(tk.K3_HDR)
    assert re.search(r"#define K3_TW (\d+)", _read("k3_tile.cuh")).group(1) \
        == str(tk.K3_TW)


_SASS_K3 = """
        Function : _ZN12_GLOBAL__N_19k3_kernelILi6ELi3EEEv6K3Args
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   SHFL.UP PT, R3, R2, 0x1, RZ ;
        /*0020*/               @P0 STS.64 [R4], R2 ;
        /*0030*/                   NOP ;
        /*0040*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_112other_kernelEv
        /*0000*/                   EXIT ;
"""
_SASS_K4 = """
        Function : _ZN12_GLOBAL__N_115axis_fft_kernelILi3ELi6ELi0EEEv8AxisArgs
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0010*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_115axis_fft_kernelILi4ELi6ELi0EEEv8AxisArgs
        /*0000*/                   EXIT ;
"""


def test_sass_kernel_counts(monkeypatch):
    """tools/sass.kernel_counts on stand-in listings: K3's kernels from
    k3_p7c's cubin and K4 inverse's (mode 3) from k4_axis0's, each
    instruction once with its guard stripped, NOP left out, other
    functions ignored; a listing without them refused."""
    from prmers_tpu_torch.tools import sass
    listings = {"k3_p7c": _SASS_K3, "k4_axis0": _SASS_K4}
    monkeypatch.setattr(sass, "library_sass", lambda source: listings[source])
    got = sass.kernel_counts()
    (k3,) = got["k3_p7c"].values()
    assert k3["issued"] == 4
    assert k3["opcodes"] == {"EXIT": 1, "MOV": 1, "SHFL.UP": 1, "STS.64": 1}
    assert list(got["k4_axis0"]) == \
        ["_ZN12_GLOBAL__N_115axis_fft_kernelILi3ELi6ELi0EEEv8AxisArgs"]
    listings["k4_axis0"] = _SASS_K3
    with pytest.raises(RuntimeError, match="no axis_fft_kernel"):
        sass.kernel_counts()
