"""K9, the whole-chain kernel, in its factored form (csrc/k9_chain.cu: each
phase runs the body of the standalone launch of its stage), on the CPU:

  (a) the torch model of its phase order (kernels.square_chain_model: K1,
      K2a, the row C-transform with the square, K2c, K3a, K3b, each the
      model of the launch whose body the phase runs) against the JAX
      package's kn.square_chain in Pallas interpret mode (its chain
      kernel allowed: PRMERS_NO_CHAIN unset) at n = 2^15 (L1 = 32, L2 =
      1) and 2^17 (L2 = 2), a = [3, 1, 3] from numpy-seeded digits and
      carries;
  (b) the model against square_chain_plain (the dense products) at all
      five shapes K9 takes, (32, 1), (64, 1), (64, 2), (64, 4), (64, 8);
  (c) the source: K9 calls axis_fft.cuh's tile, fused_c_row.cuh's group
      (the fused row form) or its split bodies, and k3b_carry.cuh's unit,
      and no dense product or table; the dense forms are gone; it
      dispatches every shape fourstep.chain_ok admits; the engine's entry
      point takes no profiler option;
  (d) what square_chain and square_chain_part hand the kernel library,
      through a stand-in for it: the factored tables, no dense one, no
      scratch;
  (e) the split row form's host-callable functions (fused_c_row.cuh:
      c_row_split, the kernel's steps in its order) built with the host's
      g++ against the dense products, forward, inverse and the squaring
      row, at ca = 2 ... 16 (K9 takes ca = 8).

Tolerance: none. The chain's digits and unit carries are exact and must
agree bit for bit; the row functions exactly mod P, after canon.
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
from prmers_tpu_torch.utils import digits as dg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "prmers_tpu_torch", "csrc")
SHAPES = {15: (32, 1, 1024), 16: (64, 1, 1024), 17: (64, 2, 1024),
          18: (64, 4, 1024), 19: (64, 8, 1024)}
DENSE = ("k1_mats", "g2", "tri", "k3_mats", "lane_f", "lane_i", "Mf", "Mi")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _p_of(n):
    return int(n * 16.5) | 1


_TABLES = {}


def _port(logn):
    if logn not in _TABLES:
        n = 1 << logn
        plan = build_plan(_p_of(n), n=n)
        fp = tfs.FourStepPlan.from_plan(plan)
        _TABLES[logn] = plan, tk.DevTables.from_host(tfs.build_tables(fp),
                                                     "cpu")
    return _TABLES[logn]


def _state(plan, t, seed):
    rng = np.random.default_rng(seed)
    v = int.from_bytes(rng.bytes(plan.p // 8 + 1), "little") % \
        ((1 << plan.p) - 1)
    x = dg.int_to_digits(v, plan.widths).reshape(t.shape)
    co = rng.integers(0, 1 << 40, size=t.carry_shape, dtype=np.uint64)
    return x, co


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# (a), (b) the model of the phase order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("logn", [15, 17])
def test_chain_model_matches_pallas_chain(logn, monkeypatch):
    """square_chain_model against the JAX kn.square_chain in interpret
    mode, a = [3, 1, 3]: digits and carries bit for bit (through
    convert.state_from_jax)."""
    monkeypatch.setenv("PRMERS_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("PRMERS_NO_CHAIN", raising=False)
    import jax.numpy as jnp
    from prmers_tpu.core.plan import build_plan as jax_plan
    from prmers_tpu.ops.pallas import fourstep as fs
    from prmers_tpu.ops.pallas import kernels as kn
    plan, t = _port(logn)
    n = 1 << logn
    fpj = fs.FourStepPlan.from_plan(jax_plan(_p_of(n), n=n))
    tj = fs.FourStepTables.build(fpj, jnp, G=8, lanes=128)
    fs.attach_mxu_tables(tj)
    fs.attach_fused_c_tables(tj)
    kn.attach_cinrow(tj)
    assert kn.chain_ok(fpj, tj) and tfs.chain_ok(t.fp)
    x, co = _state(plan, t, 200 + logn)
    a = [3, 1, 3]
    (x0, x1), (c0, c1) = convert.state_to_jax(x, co)
    jx = kn.square_chain(fpj, tj, *(jnp.asarray(v) for v in (x0, x1, c0, c1)),
                         jnp.asarray(np.array(a, dtype=np.uint32)))
    jd, jc = convert.state_from_jax(*jx)
    d, c = tk.square_chain_model(t, tgl.from_numpy_u64(x, "cpu"),
                                 tgl.from_numpy_u64(co, "cpu"), a, len(a))
    assert (jd == tgl.to_numpy_u64(d)).all()
    assert (jc == tgl.to_numpy_u64(c)).all()


@pytest.mark.parametrize("logn", sorted(SHAPES))
def test_chain_model_equals_plain(logn):
    """The model leaves the dense plain chain's digits and carries bit for
    bit at every shape K9 takes (a = [3, 1]), and count < len(a) runs
    the first count only."""
    plan, t = _port(logn)
    assert t.shape == SHAPES[logn] and tfs.chain_ok(t.fp)
    x, co = (tgl.from_numpy_u64(v, "cpu") for v in _state(plan, t, logn))
    d, c = tk.square_chain_model(t, x, co, [3, 1, 7], 2)
    dw, cw = tk.square_chain_plain(t, x, co, [3, 1], 2)
    assert torch.equal(d, dw) and torch.equal(c, cw)


# ---------------------------------------------------------------------------
# (c) the source
# ---------------------------------------------------------------------------

def _code(text):
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def test_k9_runs_the_standalone_bodies():
    """k9_chain.cuh calls axis_fft_tile in K1's, K2a's, K2c's and K3a's
    modes, fused_c_row_group (the fused row form) or the split's three
    bodies, and k3b_unit, the bodies axis_fft_kernel and
    fused_c_row_kernel run (K3's one launch runs its own tiled carry); it
    names no dense table and no dot-product
    accumulator, and no scratch buffer; the split's bodies read no dense
    table either."""
    code = _code(_read("k9_chain.cuh"))
    for mode in ("AX_K1", "AX_K2A", "AX_K2C", "AX_K3A"):
        assert f"axis_fft_tile<{mode}," in code, mode
    assert "fused_c_row_group<" in code and "k3b_unit<" in code
    for body in ("cf_lane_item_fwd<", "cf_slot_r2_sqr<", "cf_lane_item_inv<"):
        assert body in code, body
    for word in DENSE + ("axis_dft_tile", "row_slot_unit", "row_lane_dft",
                         "gl_acc_madd", "GlAcc", "S"):
        assert not re.search(r"\bg\.%s\b|\b%s\(|\b%s<" % ((word,) * 3),
                             code), word
    fft = _read("axis_fft.cuh")
    body = fft[fft.index("axis_fft_kernel(AxisArgs g) {"):]
    assert "axis_fft_tile<MODE, LL, PART>(" in body[:body.index("\n}\n")]
    row = _read("fused_c_row.cuh")
    body = row[row.index("fused_c_row_kernel("):]
    assert "fused_c_row_group<LCA, ROWS, PART>(" in \
        body[:body.index("\n}\n")]
    split = row[row.index("void cf_lane_item_fwd("):
                row.index("fused_c_row_kernel(")]
    for word in ("lane_f", "lane_i", "Mf", "Mi", "gl_acc_madd", "GlAcc"):
        assert not re.search(r"\b%s\b" % word, split), word
    assert "k3b_unit<" not in _read("k3_p7c.cu")
    assert "void k3b_unit(" in _read("k3b_carry.cuh")


def test_engine_entry_takes_no_profiler_option():
    """prmers_k9_chain (k9_chain.cu) takes the chain's arguments and the
    stream, and launches the full body with all six phases in the
    shape's row form; the cut-down body, the phase subsets and the forced
    forms are k9_part.cu's, an entry point of their own."""
    code = _code(_read("k9_chain.cu"))
    sig = code[code.index("prmers_k9_chain("):code.index(") {")]
    for word in ("part", "per_sm", "phases", "form"):
        assert not re.search(r"\b%s\b" % word, sig), word
    assert re.findall(r"k9_launch<[^>]*>", code) == \
        ["k9_launch<LL1, LL2, K9_FULL, K9_ALL, k9_split(LL1, LL2)>"]
    assert "K9_MOVE" not in code and "prmers_k9_chain_part" not in code
    head = _code(_read("k9_chain.cuh"))
    assert "int phases" not in head and "per_sm" not in head
    part = _code(_read("k9_part.cu"))
    assert "prmers_k9_chain_part(" in part and "K9_MOVE" in part


def test_dense_k9_forms_are_gone():
    """axis_dft_tile, row_slot_unit and row_lane_dft are defined and
    called nowhere in csrc/."""
    for src in os.listdir(CSRC):
        text = _read(src)
        for name in ("axis_dft_tile", "row_slot_unit", "row_lane_dft"):
            assert name not in text, (src, name)


def test_k9_dispatches_every_chain_shape():
    """Every (L1, L2) of n = 2^15 ... 2^19 (all that chain_ok admits) is
    one of the (log2 L1, log2 L2) the shape dispatch instantiates, and
    n = 2^20 is not chain_ok."""
    k9 = _read("k9_chain.cuh")
    body = k9[k9.index("int k9_shape("):]
    body = body[:body.index("\n}\n")]
    named = dict(re.findall(r"using (I\d) = std::integral_constant<int, "
                            r"(\d+)>", body))
    built = {(int(named.get(a, a)), int(b)) for a, b in re.findall(
        r"return f\((I\d)\(\), std::integral_constant<int, (\d+)>\(\)\)",
        body)}
    assert len(built) == 5
    for logn, (L1, L2, C) in SHAPES.items():
        fp = tfs.FourStepPlan.from_plan(build_plan(_p_of(1 << logn),
                                                   n=1 << logn))
        assert tfs.chain_ok(fp) and (fp.rs.L1, fp.rs.L2, fp.C) == (L1, L2, C)
        assert (L1.bit_length() - 1, L2.bit_length() - 1) in built, logn
    fp = tfs.FourStepPlan.from_plan(build_plan(_p_of(1 << 20), n=1 << 20))
    assert not tfs.chain_ok(fp)


# ---------------------------------------------------------------------------
# (d) what square_chain hands the kernel
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


@pytest.mark.parametrize("logn", [15, 19])
def test_square_chain_passes_the_factored_tables(logn, monkeypatch):
    """square_chain on a tensor taken for a CUDA one hands the library x
    and co themselves (in place, no scratch), the factored tables (k1_cs,
    k1_rs, mf, mi, t_r_inv, cs_f, cs_i, k3_rs) and no dense one, the shape,
    and the shape, to the engine's entry point; the call counter moves
    once. square_chain_part hands the same to the profiler's entry point
    with the cut-down body, none or one of the phases, or a forced row
    form, refuses any other combination, and counts nothing."""
    rec = _Recorder()
    monkeypatch.setattr(tk, "_on_cpu", lambda x: False)
    monkeypatch.setattr(tk, "_stream", lambda: 0)
    monkeypatch.setattr(build, "lib", lambda: rec)
    monkeypatch.setattr(tk, "calls", dict(tk.calls))
    _plan, t = _port(logn)
    x = torch.zeros(t.shape, dtype=torch.int64)
    co = torch.zeros(t.carry_shape, dtype=torch.int64)
    a = tk.chain_multipliers([3, 1], "cpu")
    tk.square_chain(t, x, co, a, count=2, out=x, co_out=co)
    args = rec.args["prmers_k9_chain"]
    assert len(args) == len(build.SIGNATURES["prmers_k9_chain"])
    assert args[:4] == (x.data_ptr(), co.data_ptr(), a.data_ptr(), 2)
    for name in ("k1_cs", "k1_rs", "mf", "mi", "t_r_inv", "cs_f", "cs_i",
                 "k3_rs", "wt", "cum", "er", "ec", "widths"):
        assert getattr(t, name).data_ptr() in args, name
    dense = {getattr(t, name).data_ptr() for name in DENSE}
    assert not dense & set(args)
    assert args[-5:-1] == (t.rounds,) + t.shape
    assert tk.calls["k9_chain"] == 1
    for kw, tail in (({"part": "move"}, (1, 63, 0)),
                     ({"phases": ("row",)}, (0, 4, 0)),
                     ({"phases": ()}, (0, 0, 0)),
                     ({"form": "fused"}, (0, 63, 1)),
                     ({"form": "split"}, (0, 63, 2))):
        tk.square_chain_part(t, x, co, a, 2, **kw)
        part = rec.args["prmers_k9_chain_part"]
        assert len(part) == len(build.SIGNATURES["prmers_k9_chain_part"])
        assert part[:-4] == args[:-1] and part[-4:-1] == tail, kw
    for kw in ({"phases": ("k4",)}, {"phases": ("row", "k3b")},
               {"part": "move", "phases": ("row",)},
               {"part": "move", "form": "split"},
               {"phases": ("row",), "form": "fused"}, {"form": "dense"}):
        with pytest.raises(ValueError):
            tk.square_chain_part(t, x, co, a, 2, **kw)
    assert tk.calls["k9_chain"] == 1


def test_square_chain_part_refuses_the_cpu():
    """The cut-down body computes no chain and has no plain version: on a
    CPU tensor its wrapper raises before it reaches the library."""
    _plan, t = _port(15)
    x = torch.zeros(t.shape, dtype=torch.int64)
    co = torch.zeros(t.carry_shape, dtype=torch.int64)
    a = tk.chain_multipliers([1], "cpu")
    for part in ("full", "move"):
        with pytest.raises(ValueError):
            tk.square_chain_part(t, x, co, a, 1, part)


# ---------------------------------------------------------------------------
# (e) the split row form's host functions, built with g++
# ---------------------------------------------------------------------------

SPLIT_CAS = [2, 4, 8, 16]
SPLIT_MODES = {"fwd": 0, "inv": 1, "sqr": 2}

_SPLIT_MAIN = r"""
#include <stdio.h>
#include <vector>
#include "fused_c_row.cuh"

// stdin: lca mode rows, the (C / 128, 128) tables cs_f and cs_i, then rows
// x C values; stdout: c_row_split of each row in that mode, row by row.
int main() {
    int lca, mode, rows;
    if (scanf("%d %d %d", &lca, &mode, &rows) != 3) return 1;
    const int C = 128 << lca;
    std::vector<u64> cf(C), ci(C), x((size_t)rows * C);
    for (auto& w : cf) scanf("%llu", &w);
    for (auto& w : ci) scanf("%llu", &w);
    for (auto& w : x) scanf("%llu", &w);
    for (int r = 0; r < rows; ++r)
        c_row_split(x.data() + (size_t)r * C, lca,
                    mode == 1 ? ci.data() : cf.data(), ci.data(), mode);
    for (auto w : x) printf("%llu\n", w);
    return 0;
}
"""


@pytest.fixture(scope="module")
def split_rows(tmp_path_factory):
    """csrc/fused_c_row.cuh's split row functions in a host program."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("k9split")
    src, exe = d / "main.cpp", d / "main"
    src.write_text(_SPLIT_MAIN)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", CSRC, str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    return str(exe)


def _split_tables(ca):
    """The dense and factored C-transform tables of a plan of 64 rows of
    C = 128 ca, for a (1, 2, C) register."""
    import types
    C = 128 * ca
    plan = build_plan(int(64 * C * 16.3) | 1, n=64 * C)
    fp = tfs.FourStepPlan(p=plan.p, n=64 * C, R=64, C=C,
                          rs=tfs.make_split(64), cs=tfs.make_split(C),
                          widths=plan.widths, max_word=plan.max_word)
    Mf, Mi, _wf, _wi = tfs.fused_c_mats(fp)
    cs_f, cs_i = tfs.fused_c_scales(fp)
    t = tgl.from_numpy_u64
    return types.SimpleNamespace(
        shape=(1, 2, C), Mf=t(Mf, "cpu"), Mi=t(Mi, "cpu"),
        cs_f=t(cs_f, "cpu"), cs_i=t(cs_i, "cpu"),
        lane_f=t(tfs.dft_matrix(ca, False), "cpu"),
        lane_i=t(tfs.dft_matrix(ca, True), "cpu"))


@pytest.mark.parametrize("mode", sorted(SPLIT_MODES))
@pytest.mark.parametrize("ca", SPLIT_CAS)
def test_split_rows_match_dense(split_rows, ca, mode):
    """c_row_split on lazy words (any u64) equals the dense products: the
    lane DFT and slot products (fwd), the slot products and inverse lane
    DFT (inv), and the whole C-transform with the square (sqr, what K9's
    three split phases compute), after canon."""
    t = _split_tables(ca)
    rng = np.random.default_rng(100 * ca + SPLIT_MODES[mode])
    x = rng.integers(0, 1 << 64, size=(2, 128 * ca), dtype=np.uint64)
    words = [ca.bit_length() - 1, SPLIT_MODES[mode], 2] + \
        tgl.to_numpy_u64(t.cs_f).reshape(-1).tolist() + \
        tgl.to_numpy_u64(t.cs_i).reshape(-1).tolist() + x.reshape(-1).tolist()
    r = subprocess.run([split_rows], input="\n".join(map(str, words)),
                       capture_output=True, text=True, check=True)
    got = np.array([int(v) for v in r.stdout.split()], dtype=np.uint64)
    v = tgl.from_numpy_u64(x, "cpu").reshape(1, 2, 128 * ca)
    if mode == "inv":
        want = tk.fused_c_invh_plain(t, v, "")
    else:
        want = tk.fused_c_plain(t, v, "fwd" if mode == "fwd" else "sqr",
                                r2fold=False)
    canon = tgl.to_numpy_u64(tgl.canon64(tgl.from_numpy_u64(got, "cpu")))
    assert (canon == tgl.to_numpy_u64(tgl.canon64(want)).reshape(-1)).all()
