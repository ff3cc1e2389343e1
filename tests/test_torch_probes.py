"""The port's probe kernels (ops/probes.py) and field ops (ops/mers.py) on
the CPU, against the JAX package and numpy; the factory's refusals of the
unported pipeline switches; the tools' entry points.

  * ops/mers.py's M31C and M61C against the JAX's mers.M31C(jnp) and
    M61C(jnp): the same words out for the same words in (lazy forms
    included), and after canon;
  * the rep-loop plain bodies (probe_vpu, probe_mulmod, probe_fields) at
    (8, 128) with 2 reps against GL(jnp), M31C(jnp) and M61C(jnp) looped
    the same way, after canon, and against big-int;
  * csrc/gl64.cuh and csrc/mers.cuh compiled for the host (the headers are
    host-callable) against the plain rep bodies;
  * each shape case's plain version against numpy, and the bitcast's plain
    order;
  * create_engine's NotImplementedError under PRMERS_NO_MXU,
    PRMERS_NO_WFOLD and PRMERS_NO_FUSE, one test each.

Tolerance: none (exact integers; field values after canon).
"""

import importlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from prmers_tpu_torch.engine import factory
from prmers_tpu_torch.ops import gl64 as tgl
from prmers_tpu_torch.ops import mers as tm
from prmers_tpu_torch.ops import probes as pr

GP = (1 << 64) - (1 << 32) + 1
M31 = (1 << 31) - 1
M61 = (1 << 61) - 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _words(rng, shape, hi=1 << 32):
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _jax_ops():
    import jax.numpy as jnp
    from prmers_tpu.ops.pallas import mers as jm
    from prmers_tpu.ops.pallas.gl64 import GL
    return jnp, GL(jnp), jm.M31C(jnp), jm.M61C(jnp)


@pytest.mark.parametrize("hi", [1 << 30, 1 << 32])
@pytest.mark.parametrize("op", ["m31_mul", "m31_sqr", "m61_mul", "m61_sqr",
                                "m31_canon", "m61_canon"])
def test_mers_matches_jax_word_for_word(op, hi):
    jnp, _g, j31, j61 = _jax_ops()
    t31, t61 = tm.M31C(), tm.M61C()
    rng = np.random.default_rng(hi % 97 + len(op))
    k = {"m31_mul": 4, "m31_sqr": 2, "m61_mul": 8, "m61_sqr": 4,
         "m31_canon": 1, "m61_canon": 2}[op]
    ins = [_words(rng, (8, 128), hi) for _ in range(k)]
    if op.startswith("m61"):
        # an M61 value is lazy < 2^62: its high words stay below 2^30
        ins = [a if i % 2 == 0 else a & np.uint32((1 << 30) - 1)
               for i, a in enumerate(ins)]
    jf = {"m31_mul": j31.mul, "m31_sqr": j31.sqr, "m61_mul": j61.mul,
          "m61_sqr": j61.sqr, "m31_canon": j31.canon,
          "m61_canon": j61.canon}[op]
    tf = {"m31_mul": t31.mul, "m31_sqr": t31.sqr, "m61_mul": t61.mul,
          "m61_sqr": t61.sqr, "m31_canon": t31.canon,
          "m61_canon": t61.canon}[op]
    want = jf(*[jnp.asarray(a) for a in ins])
    got = tf(*[torch.from_numpy(a.astype(np.int64)) for a in ins])
    if op == "m31_canon":
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert (np.asarray(w).astype(np.int64) == g.numpy()).all()


def test_mers_pack_helpers():
    x = np.array([0, 1, M61 - 1, (1 << 62) - 5], dtype=np.uint64)
    lo, hi = tm.m61_to_pairs(x)
    assert lo.dtype == np.uint32 and (tm.m61_from_pairs(lo, hi) == x).all()


def _values(op, planes):
    """The field values of a rep op's planes (python ints): gl64 and M61
    pairs joined, M31 words as they are; reduced mod the field."""
    w = [p.astype(object) for p in planes]
    if op.startswith("gl"):
        return [(w[i] + (w[i + 1] << 32)) % GP for i in range(0, len(w), 2)]
    if op.startswith("m31"):
        return [a % M31 for a in w]
    return [(w[i] + (w[i + 1] << 32)) % M61 for i in range(0, len(w), 2)]


def _bigint_rep(op, vals, reps):
    """op applied reps times in python ints (a complex value (re, im))."""
    mod = GP if op.startswith("gl") else (M31 if op.startswith("m31")
                                          else M61)
    if op.startswith("gl"):
        a = vals[0]
        for _ in range(reps):
            a = a * (vals[1] if op == "gl_mul" else a) % mod
        return [a] + vals[1:]
    re, im = vals[0], vals[1]
    for _ in range(reps):
        br, bi = (vals[2], vals[3]) if op.endswith("mul") else (re, im)
        re, im = (re * br - im * bi) % mod, (re * bi + im * br) % mod
    return [re, im] + vals[2:]


@pytest.mark.parametrize("op", pr.FIELD_OPS)
def test_rep_bodies_match_jax_and_bigint(op):
    """probe_fields' plain loop, 2 reps at (8, 128): against the JAX's
    field classes looped the same way (after canon), and against big-int
    on every element."""
    jnp, g, j31, j61 = _jax_ops()
    x = pr.rep_inputs(op, (8, 128), seed=3)
    got = pr.fields(op, x, 2)                    # on the CPU: the plain loop
    ins = [jnp.asarray(p.numpy().astype(np.uint32)) for p in x]
    body = {"gl_mul": lambda *a: g.mul(*a) + a[2:],
            "gl_sqr": lambda *a: g.sqr(*a),
            "m31_mul": lambda *a: j31.mul(*a) + a[2:],
            "m31_sqr": lambda *a: j31.sqr(*a),
            "m61_mul": lambda *a: j61.mul(*a) + a[4:],
            "m61_sqr": lambda *a: j61.sqr(*a)}[op]
    for _ in range(2):
        ins = body(*ins)
    want = torch.stack([torch.from_numpy(np.asarray(a).astype(np.int64))
                        for a in ins])
    assert torch.equal(pr.canon_planes(op, got),
                       pr.canon_planes(op, pr.bits32(want)))
    vals = _values(op, [p.numpy().astype(np.uint64) & 0xFFFFFFFF
                        for p in pr.words(x)])
    big = _bigint_rep(op, vals, 2)
    mine = _values(op, [p.numpy() for p in pr.words(got)])
    for a, b in zip(mine, big):
        assert (a == b).all()


def test_vpu_and_mulmod_plain():
    """probe_vpu: y = y * x + 1 as int32 wraps (numpy); probe_mulmod: a *
    b^2 mod P as big-int, its (lo, hi) out of the four planes in."""
    x = pr.rep_inputs("vpu", (8, 128), seed=5)[0].contiguous()
    y = x.numpy().astype(np.int64)
    for _ in range(2):
        y = (y * x.numpy().astype(np.int64) + 1) & 0xFFFFFFFF
    assert (pr.words(pr.vpu(x, 2)).numpy() == y).all()
    ab = pr.rep_inputs("gl_mul", (8, 128), seed=6)
    got = pr.mulmod(ab, 2)
    assert tuple(got.shape) == (2, 8, 128)
    w = [p.numpy().astype(object) for p in pr.words(ab)]
    a, b = w[0] + (w[1] << 32), w[2] + (w[3] << 32)
    g = [p.numpy().astype(object) for p in pr.words(got)]
    assert ((g[0] + (g[1] << 32)) % GP == a * b * b % GP).all()


_HOST_MAIN = r"""
#include <cstdio>
#include "mers.cuh"
// reads: op reps N, then the op's planes of N words; writes the planes
int main() {
    int op, reps; long N;
    if (scanf("%d %d %ld", &op, &reps, &N) != 3) return 1;
    const int nin[] = {1, 4, 2, 4, 2, 8, 4};
    static u32 w[8][1 << 12];
    for (int p = 0; p < nin[op]; ++p)
        for (long i = 0; i < N; ++i) scanf("%u", &w[p][i]);
    for (long i = 0; i < N; ++i) {
        if (op == 1 || op == 2) {
            u64 a = w[0][i] | ((u64)w[1][i] << 32);
            const u64 b = w[2][i] | ((u64)w[3][i] << 32);
            for (int r = 0; r < reps; ++r) a = op == 1 ? gl_mul(a, b)
                                                         : gl_sqr(a);
            w[0][i] = (u32)a; w[1][i] = (u32)(a >> 32);
        } else if (op == 3 || op == 4) {
            u32 ar = w[0][i], ai = w[1][i];
            for (int r = 0; r < reps; ++r) {
                if (op == 3) m31c_mul(ar, ai, w[2][i], w[3][i], ar, ai);
                else m31c_sqr(ar, ai, ar, ai);
            }
            w[0][i] = ar; w[1][i] = ai;
        } else {
            u64 ar = w[0][i] | ((u64)w[1][i] << 32);
            u64 ai = w[2][i] | ((u64)w[3][i] << 32);
            const u64 br = w[4][i] | ((u64)w[5][i] << 32);
            const u64 bi = w[6][i] | ((u64)w[7][i] << 32);
            for (int r = 0; r < reps; ++r) {
                if (op == 5) m61c_mul(ar, ai, br, bi, ar, ai);
                else m61c_sqr(ar, ai, ar, ai);
            }
            w[0][i] = (u32)ar; w[1][i] = (u32)(ar >> 32);
            w[2][i] = (u32)ai; w[3][i] = (u32)(ai >> 32);
        }
    }
    for (int p = 0; p < nin[op]; ++p)
        for (long i = 0; i < N; ++i) printf("%u\n", w[p][i]);
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_headers(tmp_path_factory):
    """csrc/gl64.cuh and mers.cuh built into a host program with g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("hdr")
    src, exe = d / "main.cpp", d / "main"
    src.write_text(_HOST_MAIN)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I",
                    os.path.join(ROOT, "prmers_tpu_torch", "csrc"), str(src),
                    "-o", str(exe)], check=True, capture_output=True)
    return str(exe)


@pytest.mark.parametrize("op", pr.FIELD_OPS)
def test_device_headers_match_plain(host_headers, op):
    """The kernel's arithmetic (gl64.cuh, mers.cuh: native 64-bit words)
    equals the plain rep loop after canon, 5 reps on 1024 elements."""
    op_id, n_in = pr.REP_OPS[op]
    x = pr.rep_inputs(op, (8, 128), seed=9)
    words = pr.words(x).numpy().reshape(n_in, -1)
    stdin = f"{op_id} 5 {words.shape[1]}\n" + "\n".join(
        str(int(v)) for v in words.reshape(-1))
    r = subprocess.run([host_headers], input=stdin, capture_output=True,
                       text=True, check=True)
    got = np.array([int(v) for v in r.stdout.split()], dtype=np.int64)
    got = pr.bits32(torch.from_numpy(got.reshape(x.shape)))
    want = pr.reps_plain(op, x, 5)
    assert torch.equal(pr.canon_planes(op, got), pr.canon_planes(op, want))


def _np_case(case, xs):
    """Each shape case in numpy, from the TPU probes' definitions."""
    a = [x.numpy() for x in xs]
    if case in ("b", "e", "n"):
        w, x = a[0].astype(np.int64), a[1].astype(np.int64)
        d = w @ x.reshape(x.shape[0], -1)
        if case == "b":
            return d.reshape(576, 64, 128)
        if case == "e":
            return d
        return sum(d[64 * m:64 * (m + 1)] for m in range(9))
    x = a[0]
    u = x.view(np.uint32)
    return {
        "a": lambda: x.reshape(64, 64, 128),
        "c": lambda: np.concatenate([x] * 8, axis=0),
        "d": lambda: x.reshape(9, 64, 64, 128),
        "f": lambda: u.astype(np.uint8).view(np.int8),
        "g": lambda: np.concatenate([x] * 8, axis=1),
        "h": lambda: x[64:128, :],
        "i": lambda: x[:, 128:256],
        "j": lambda: sum(u[:, j, :] for j in range(8)).astype(np.uint32)
        .view(np.int32),
        "k": lambda: (u + np.uint32(1)).view(np.int32),
        "l": lambda: x[:, 0, :].reshape(64, 1, 128),
        "m": lambda: np.concatenate(
            [np.concatenate([x[:, j, :] for j in range(8)], axis=1)] * 8,
            axis=0),
    }[case]()


@pytest.mark.parametrize("case", list(pr.SHAPE_CASES))
def test_shape_case_plain_matches_numpy(case):
    xs = pr.shape_inputs(case, seed=1)
    got = pr.shape_case(case, *xs)           # on the CPU: the plain version
    want = _np_case(case, xs)
    assert tuple(got.shape) == want.shape
    assert (got.numpy().astype(np.int64) == want.astype(np.int64)).all()


def test_shape_case_refuses_bad_inputs():
    xs = pr.shape_inputs("e")
    with pytest.raises(ValueError):
        pr.shape_case("e", xs[1], xs[0])
    with pytest.raises(ValueError):
        pr.shape_case("k", xs[0])


def test_bitcast_plain_order():
    """Row 4l + b holds byte b of word l: word-major ("interleaved") on a
    little-endian host, as the TPU's interpret mode gave."""
    v = pr.bitcast_pattern()
    got = pr.bitcast(torch.from_numpy(v.view(np.int32)))
    assert tuple(got.shape) == (32, 128)
    want = v.view(np.uint8).reshape(8, 128, 4).transpose(0, 2, 1) \
        .reshape(32, 128).view(np.int8)
    assert (got.numpy() == want).all()
    assert pr.bitcast_order(got[:, 0].tolist()) == "interleaved"
    assert pr.bitcast_order([l * 4 + b for b in range(4)
                             for l in range(8)]) == "plane-major"


@pytest.mark.parametrize("switch", factory.UNPORTED_SWITCHES)
def test_factory_refuses_unported_switch(monkeypatch, switch):
    for name in factory.UNPORTED_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(switch, "1")
    with pytest.raises(NotImplementedError, match=switch):
        factory.create_engine(756839, 2, device="cpu")


TOOLS = ("profile_passes", "microbench", "microbench_fields", "probe_shapes",
         "probe_bitcast")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_and_needs_a_card(monkeypatch, tool):
    """Each tool imports without running anything, and its entry point
    refuses to measure where there is no card."""
    mod = importlib.import_module(f"prmers_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
