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
  * csrc/probe_copy.cuh (the copy cases' index maps of the shape probes'
    kernel) compiled for the host against each copy case's plain version;
  * the wrappers' `out=` on the plain path and their refusals of a wrong
    shape, type, device or a non-contiguous out;
  * the tools' timing statistics (tools.PairTimes) and the SASS loop
    count (tools/sass.py) on a made-up listing;
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


_COPY_MAIN = r"""
#include <cstdio>
#include <vector>
#include "probe_copy.cuh"
// argv: case, input file, output file; output unit q = copy_unit(in, q)
template <int CS>
int run(const char* src, const char* dst) {
    FILE* f = fopen(src, "rb");
    std::vector<W4> in;
    W4 v;
    while (fread(&v, sizeof v, 1, f) == 1) in.push_back(v);
    fclose(f);
    std::vector<W4> out(COPY_UNITS<CS>);
    for (int q = 0; q < COPY_UNITS<CS>; ++q)
        out[q] = copy_unit<CS>(in.data(), q);
    f = fopen(dst, "wb");
    fwrite(out.data(), sizeof(W4), out.size(), f);
    fclose(f);
    return 0;
}
int main(int argc, char** argv) {
    if (argc != 4) return 2;
    switch (argv[1][0]) {
        case 'a': return run<'a'>(argv[2], argv[3]);
        case 'c': return run<'c'>(argv[2], argv[3]);
        case 'd': return run<'d'>(argv[2], argv[3]);
        case 'f': return run<'f'>(argv[2], argv[3]);
        case 'g': return run<'g'>(argv[2], argv[3]);
        case 'h': return run<'h'>(argv[2], argv[3]);
        case 'i': return run<'i'>(argv[2], argv[3]);
        case 'j': return run<'j'>(argv[2], argv[3]);
        case 'k': return run<'k'>(argv[2], argv[3]);
        case 'l': return run<'l'>(argv[2], argv[3]);
        case 'm': return run<'m'>(argv[2], argv[3]);
    }
    return 2;
}
"""
COPY_CASES = [c for c in pr.SHAPE_CASES if c not in "ben"]


@pytest.fixture(scope="module")
def host_copy(tmp_path_factory):
    """csrc/probe_copy.cuh built into a host program with g++, once."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("copy")
    src, exe = d / "main.cpp", d / "main"
    src.write_text(_COPY_MAIN)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I",
                    os.path.join(ROOT, "prmers_tpu_torch", "csrc"), str(src),
                    "-o", str(exe)], check=True, capture_output=True)
    return str(exe)


@pytest.mark.parametrize("case", COPY_CASES)
def test_copy_index_maps_match_plain(host_copy, tmp_path, case):
    """Each copy case's 16-byte index map (copy_unit, the kernel's body)
    on seeded inputs equals the case's plain version byte for byte."""
    xs = pr.shape_inputs(case, seed=2)
    want = pr.shape_plain(case, *xs).numpy()
    (tmp_path / "in").write_bytes(xs[0].numpy().tobytes())
    subprocess.run([host_copy, case, str(tmp_path / "in"),
                    str(tmp_path / "out")], check=True)
    got = np.frombuffer((tmp_path / "out").read_bytes(), dtype=want.dtype)
    assert got.size == want.size
    assert (got.reshape(want.shape) == want).all()


def _out_cases():
    """(wrapper, call(out), the result's shape and type) for each wrapper
    that takes out=."""
    v = pr.rep_inputs("vpu", (8, 128), seed=4)[0].contiguous()
    ab = pr.rep_inputs("gl_mul", (8, 128), seed=4)
    m61 = pr.rep_inputs("m61_sqr", (8, 128), seed=4)
    w, x = (torch.from_numpy(np.random.default_rng(4).integers(
        -128, 128, size=s, dtype=np.int64).astype(np.int8))
        for s in ((128, 64), (64, 32)))
    bc = torch.from_numpy(pr.bitcast_pattern().view(np.int32))
    k = pr.shape_inputs("k", seed=4)
    return {
        "shape_case": (lambda o: pr.shape_case("k", *k, out=o),
                       lambda: pr.shape_plain("k", *k)),
        "shape_case_dot": (lambda o: pr.shape_case(
            "e", *pr.shape_inputs("e", seed=4), out=o),
            lambda: pr.shape_plain("e", *pr.shape_inputs("e", seed=4))),
        "dot8": (lambda o: pr.dot8(w, x, 64, out=o),
                 lambda: pr.dot8_plain(w, x, 64)),
        "vpu": (lambda o: pr.vpu(v, 3, out=o),
                lambda: pr.reps_plain("vpu", v.unsqueeze(0), 3)[0]),
        "mulmod": (lambda o: pr.mulmod(ab, 3, out=o),
                   lambda: pr.reps_plain("gl_mul", ab, 3)[:2]),
        "fields": (lambda o: pr.fields("m61_sqr", m61, 3, out=o),
                   lambda: pr.reps_plain("m61_sqr", m61, 3)),
        "bitcast": (lambda o: pr.bitcast(bc, out=o),
                    lambda: pr.bitcast_plain(bc)),
    }


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """x's copy in a contiguous view one element past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 16, dtype=x.dtype)
    return flat[1:1 + x.numel()].view(x.shape).copy_(x)


OUT_WRAPPERS = ("shape_case", "shape_case_dot", "dot8", "vpu", "mulmod",
                "fields", "bitcast")


@pytest.mark.parametrize("wrapper", OUT_WRAPPERS)
def test_out_argument_on_the_plain_path(wrapper):
    """A wrapper given out= fills it with the plain version's result and
    returns it; it raises on an out of another shape, type or device, a
    non-contiguous one or one off a 16-byte boundary, and leaves such an
    out as it was."""
    call, plain = _out_cases()[wrapper]
    want = plain()
    out = torch.full_like(want, -7)
    got = call(out)
    assert got.data_ptr() == out.data_ptr() and torch.equal(out, want)
    shape, dtype = tuple(want.shape), want.dtype
    other = torch.int8 if dtype == torch.int32 else torch.int32
    bad = [torch.empty(shape[:-1] + (shape[-1] + 16,), dtype=dtype),
           torch.empty(shape, dtype=other),
           torch.empty(shape, dtype=dtype, device="meta"),
           torch.zeros(shape + (2,), dtype=dtype)[..., 0],
           _misaligned(torch.zeros(shape, dtype=dtype))]
    assert not bad[3].is_contiguous() and bad[4].data_ptr() % 16
    for b in bad:
        with pytest.raises(ValueError, match="out must be"):
            call(b)
    assert not bad[3].any()


def test_pair_times_statistics():
    """The tools' timing statistics: the median of the pairs is the time,
    the mean and the largest stand beside it; one stalled pair moves the
    mean and the max, not the median."""
    from prmers_tpu_torch.tools import PairTimes
    t = PairTimes((0.0052, 0.0049, 0.0051, 0.3877, 0.0050))
    assert t.median == pytest.approx(0.0051)
    assert t.mean == pytest.approx((0.0052 + 0.0049 + 0.0051 + 0.3877 +
                                    0.0050) / 5)
    assert t.max == pytest.approx(0.3877)
    assert t.row() == {"median_ms": t.median, "mean_ms": t.mean,
                       "max_ms": t.max}
    assert PairTimes((1.0, 3.0)).median == pytest.approx(2.0)


_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_110rep_kernelILi1EEEvPKjPjiim
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0020*/                   IMAD.WIDE.U32 R4, R2, R6, RZ ;
        /*0030*/                   IMAD.HI.U32 R8, R2, R6, RZ ;
        /*0040*/                   IADD3 R2, P1, R4, R8, RZ ;
        /*0050*/                   NOP ;
        /*0060*/                   IMAD.X R3, R5, 0x1, R9, P1 ;
        /*0070*/                   IADD3 R0, R0, 0x4, RZ ;
        /*0080*/                   ISETP.GE.AND P0, PT, R0, R7, PT ;
        /*0090*/              @!P0 BRA `(.L_x_1) ;
.L_x_0:
        /*00a0*/                   LOP3.LUT R2, R2, 0xff, RZ, 0xc0, !PT ;
        /*00b0*/                   IADD3 R2, R2, 0x1, RZ ;
        /*00c0*/               @P0 BRA 0xa0 ;
        /*00d0*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_111copy_kernelILi97EEEvPK2W4PS0_
        /*0000*/                   BRA 0x0 ;
"""


# rep_kernel<0>'s loops as nvcc 12 built them for sm_90a: the rep loop
# unrolled 4 times (its counter counted down by 4), and the remainder
_SASS_VPU = """
		Function : _ZN46_GLOBAL__N__51201dd0_13_probe_reps_cu_9774b37910rep_kernelILi0EEEvPKjPjiim
        /*01a0*/              @!P1 BRA 0x240 ;
        /*01b0*/                   IMAD.IADD R3, R7, 0x1, -R0 ;
        /*01c0*/                   IMAD.MOV.U32 R5, RZ, RZ, R2 ;
        /*01d0*/                   IADD3 R3, R3, -0x4, RZ ;
        /*01e0*/                   IMAD R5, R2, R5, 0x1 ;
        /*01f0*/                   ISETP.NE.AND P1, PT, R3, RZ, PT ;
        /*0200*/                   IMAD R5, R2, R5, 0x1 ;
        /*0210*/                   IMAD R5, R2, R5, 0x1 ;
        /*0220*/                   IMAD R5, R2, R5, 0x1 ;
        /*0230*/               @P1 BRA 0x1d0 ;
        /*0240*/              @!P0 BRA 0x290 ;
        /*0250*/                   VIADD R0, R0, 0xffffffff ;
        /*0260*/                   IMAD R5, R2, R5, 0x1 ;
        /*0270*/                   ISETP.NE.AND P0, PT, R0, RZ, PT ;
        /*0280*/               @P0 BRA 0x250 ;
        /*0290*/                   EXIT ;
"""


def test_sass_loop_count():
    """tools/sass.py on listings: the largest loop (a label or an address
    target) of rep_kernel<OP>, its unroll read from the step of the
    counter that its closing branch tests (up or down, IADD3 or VIADD),
    its instructions by pipe (IMAD.WIDE and IMAD.HI two FMA slots, NOP
    none, the branch on neither) over the unroll, the busier pipe its
    slots; another function's loop ignored; a loop with no counter step
    refused."""
    from prmers_tpu_torch.tools import sass
    funcs = sass.functions(_SASS)
    insns = funcs["_ZN12_GLOBAL__N_110rep_kernelILi1EEEvPKjPjiim"]
    assert sorted(sass.loops(insns)) == [(2, 9), (10, 12)]
    c = sass.loop_count(insns)
    assert c["unroll"] == 4
    assert (c["fma_per_rep"], c["alu_per_rep"], c["neither_per_rep"],
            c["issued_per_rep"]) == (5 / 4, 3 / 4, 1 / 4, 7 / 4)
    assert c["slots_per_rep"] == 5 / 4 and c["loops"] == 2
    assert c["opcodes"]["IMAD.WIDE.U32"] == 1 and "NOP" not in c["opcodes"]
    with pytest.raises(RuntimeError, match="no rep_kernel"):
        sass.rep_counts(_SASS)
    vpu = sass.functions(_SASS_VPU)
    c = sass.loop_count(next(iter(vpu.values())))
    assert (c["unroll"], c["fma_per_rep"], c["alu_per_rep"],
            c["issued_per_rep"], c["slots_per_rep"]) == (4, 1, 0.5, 1.75, 1)

    # the ALU the busier pipe; VIADD on the less busy one; the issue limit
    def listing(ops, step):
        body = ops + [step, "ISETP.NE.AND P0, PT, R9, RZ, PT"]
        return [(16 * i, t.split()[0], t, None)
                for i, t in enumerate(body)] + \
            [(16 * len(body), "BRA", "@P0 BRA 0x0", None)]

    alu = listing(["IADD3"] * 8 + ["IMAD"] * 2 + ["VIADD"] * 2,
                  "VIADD R9, R9, 0xfffffffe")
    assert sass.loop_count(alu)["unroll"] == 2
    assert sass.loop_count(alu)["slots_per_rep"] == 9 / 2
    flex = listing(["IADD3"] * 2 + ["VIADD"] * 8, "IADD3 R9, R9, 0x1, RZ")
    assert sass.loop_count(flex)["slots_per_rep"] == max(4, 12 / 2, 13 / 2)
    for step in ("IADD3 R8, R8, 0x4, RZ",        # not the tested register
                 "IADD3 R9, R8, 0x4, RZ",        # not a step of itself
                 "IADD3 R9, R9, R2, RZ"):        # no immediate
        with pytest.raises(ValueError, match="no counter step"):
            sass.loop_count(listing(["IMAD"] * 4, step))


def test_shape_case_refuses_bad_inputs():
    xs = pr.shape_inputs("e")
    with pytest.raises(ValueError):
        pr.shape_case("e", xs[1], xs[0])
    with pytest.raises(ValueError):
        pr.shape_case("k", xs[0])
    # the copy kernel's and dot8's 16-byte moves: inputs at an odd offset
    k = _misaligned(pr.shape_inputs("k")[0])
    assert k.is_contiguous() and k.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        pr.shape_case("k", k)
    with pytest.raises(ValueError, match="aligned"):
        pr.shape_case("e", _misaligned(xs[0]), xs[1])
    with pytest.raises(ValueError, match="aligned"):
        pr.dot8(xs[0], _misaligned(xs[1]))


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
         "probe_bitcast", "sass", "timing_audit")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_and_needs_a_card(monkeypatch, tool):
    """Each tool imports without running anything, and its entry point
    refuses to measure where there is no card."""
    mod = importlib.import_module(f"prmers_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
