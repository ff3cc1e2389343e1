"""The port's ops/ntt2.py against the JAX package's on the CPU: the
copied capacity functions, the tables (the fast build and the copied
scalar loops, bit for bit), each plain stage of K10-K12 against the
reference's stage on numpy, forward_3161 / inverse_3161 / carry_3161
against the torch compositions, the static round bound of the carry
reached, and csrc/f3_ntt.cuh (the kernels' per-thread bodies) built
with the host's g++ against the plain versions."""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from prmers_tpu.core.field2 import Fq2Ops, M31, M61
from prmers_tpu.ops import ntt2 as jn
from prmers_tpu_torch.ops import kernels as tk
from prmers_tpu_torch.ops import ntt2 as tn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
O31, O61 = Fq2Ops(np, M31, 31), Fq2Ops(np, M61, 61)
# every stage shape family: 2^k (odd and even k), 3 2^k, 9 2^k
SIZES = [8, 24, 32, 72, 256, 288, 384, 3072]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _p_for(n: int) -> int:
    """An odd exponent near the middle of the shape's capacity."""
    return (n * tn.max_bpw_3161(n) // 2) | 1


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(
        a, dtype=np.uint64)).view(np.int64).copy())


def _u(x: torch.Tensor) -> np.ndarray:
    return x.numpy().astype(np.int64).view(np.uint64)


def _planes(pair31, pair61):
    """Reference (re, im) numpy pairs as the port's (2, n) planes."""
    return (torch.from_numpy(np.stack(pair31).astype(np.int32)),
            _t(np.stack(pair61)))


def _ref_stage(ops, x, pt, i, inverse):
    """Stage i of the reference's plane_fwd / plane_inv loop bodies
    (ntt2.py:264-317) on numpy, from its own _bfly and tables."""
    n = x[0].shape[0]
    r, tw, twi = pt.stages[i]
    L = n
    for k in range(i):
        L //= pt.stages[k][0]
    m, B = L // r, n // L
    vre, vim = x[0].reshape(B, r, m), x[1].reshape(B, r, m)
    parts = [(vre[:, k], vim[:, k]) for k in range(r)]
    if inverse:
        parts = parts[:1] + [ops.mul((twi[0][k][None, :], twi[1][k][None, :]),
                                     parts[k]) for k in range(1, r)]
    outs = jn._bfly(ops, parts, inverse)
    if not inverse:
        outs = outs[:1] + [ops.mul((tw[0][k][None, :], tw[1][k][None, :]),
                                   outs[k]) for k in range(1, r)]
    return (np.stack([o[0] for o in outs], axis=1).reshape(n),
            np.stack([o[1] for o in outs], axis=1).reshape(n))


def _digits(t, seed):
    """Random digits of the tables' widths (numpy or device tables)."""
    rng = np.random.default_rng(seed)
    masks = t.masks if isinstance(t.masks, np.ndarray) else _u(t.masks)
    return rng.integers(0, 1 << 62, t.n, dtype=np.uint64) & masks


def test_copy_keeps_every_reference_definition():
    """Every definition of the reference's ops/ntt2.py is in the port
    unchanged (the ast; tests/test_torch_host.py's comparison) but the
    two the header lists: build_tables (its `fast` switch) and carry_3161
    (the numpy loop alone, no jax branch)."""
    from test_torch_host import _definitions
    a = _definitions(os.path.join(ROOT, "prmers_tpu", "ops", "ntt2.py"))
    b = _definitions(os.path.join(ROOT, "prmers_tpu_torch", "ops",
                                  "ntt2.py"))
    assert set(a) <= set(b)
    assert {k for k in a if a[k] != b[k]} == {"build_tables", "carry_3161"}


def test_capacity_functions_are_the_reference():
    assert tn.LOG2_CRT == jn.LOG2_CRT
    assert tn.shape_table_3161(27) == jn.shape_table_3161(27)
    for p in (31, 127, 1279, 9941, 11213, 100003, 756839, 3021377,
              136279841, 2147483647, 6000000000):
        assert tn.transform_size_3161(p) == jn.transform_size_3161(p)
    for n in SIZES + [1 << 22, 9 << 20]:
        assert tn.max_bpw_3161(n) == jn.max_bpw_3161(n)
        assert tn.max_exponent_3161(n) == jn.max_exponent_3161(n)
        assert tn.radix_seq_23(n) == jn.radix_seq_23(n)
    assert tn.transform_size_3161(136279841) == 1 << 22
    assert tn.radix_seq_23(288) == (3, 3, 2, 4, 4)


def _same_tables(a, b):
    assert (a.p, a.n, a.crt_minv) == (b.p, b.n, b.crt_minv)
    for x, y in ((a.widths, b.widths), (a.masks, b.masks)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for pa, pb in ((a.p31, b.p31), (a.p61, b.p61)):
        assert (pa.q, pa.s) == (pb.q, pb.s)
        assert len(pa.stages) == len(pb.stages)
        for (ra, ta, ia), (rb, tb, ib) in zip(pa.stages, pb.stages):
            assert ra == rb
            for x, y in zip(ta + ia, tb + ib):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert np.array_equal(x, y)
        assert sorted(pa.dmat) == sorted(pb.dmat)
        for r in pa.dmat:
            for x, y in zip(pa.dmat[r][0] + pa.dmat[r][1],
                            pb.dmat[r][0] + pb.dmat[r][1]):
                assert np.array_equal(x, y)
        for x, y in zip(pa.weights + pa.unweights, pb.weights + pb.unweights):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("n", SIZES)
def test_tables_bit_for_bit(n):
    """The fast build, the copied scalar loops and the reference's
    build_tables give the same arrays."""
    p = _p_for(n)
    ref = jn.build_tables(p, n, np)
    _same_tables(tn.build_tables(p, n, np), ref)
    _same_tables(tn.build_tables(p, n, np, fast=False), ref)


@pytest.mark.parametrize("n", SIZES)
def test_plain_stages_equal_the_reference(n):
    """Each plain K10 / K11 stage and K12 on the same input as the
    reference's stage: word for word (both canonical); forward_3161's
    spectrum, inverse_3161's exact (lo, hi) and carry_3161's digits at
    the boundaries."""
    p = _p_for(n)
    ht = jn.build_tables(p, n, np)
    t = tn.DevTables3161.from_host(tn.build_tables(p, n, np), "cpu")
    d = _digits(ht, n)
    x31 = x61 = None
    r31 = O31.mul(ht.p31.weights, (O31.norm(d), 0 * d))
    r61 = O61.mul(ht.p61.weights, (O61.norm(d), 0 * d))
    for i in range(len(t.stages)):
        x31, x61 = tn.fwd_stage_plain(t, i, x31, x61,
                                      _t(d) if i == 0 else None)
        r31 = _ref_stage(O31, r31, ht.p31, i, False)
        r61 = _ref_stage(O61, r61, ht.p61, i, False)
        want = _planes(r31, r61)
        assert torch.equal(x31, want[0]) and torch.equal(x61, want[1]), i
    s31, s61 = jn.forward_3161(O31, O61, ht, d)
    assert torch.equal(x31, _planes(s31, s61)[0])
    assert torch.equal(x61, _planes(s31, s61)[1])
    m = _planes(*jn.forward_3161(O31, O61, ht, _digits(ht, n + 1)))
    y31, y61 = tn.pointwise_plain(x31, x61, *m)
    want = _planes(O31.mul(s31, (m[0][0].numpy().astype(np.uint64),
                                 m[0][1].numpy().astype(np.uint64))),
                   O61.mul(s61, (_u(m[1][0]), _u(m[1][1]))))
    assert torch.equal(y31, want[0]) and torch.equal(y61, want[1])
    x31, x61 = tn.pointwise_plain(x31, x61)
    r31, r61 = O31.sqr(s31), O61.sqr(s61)
    assert torch.equal(x31, _planes(r31, r61)[0])
    assert torch.equal(x61, _planes(r31, r61)[1])
    for i in range(len(t.stages) - 1, 0, -1):
        x31, x61 = tn.inv_stage_plain(t, i, x31, x61)
        r31 = _ref_stage(O31, r31, ht.p31, i, True)
        r61 = _ref_stage(O61, r61, ht.p61, i, True)
        want = _planes(r31, r61)
        assert torch.equal(x31, want[0]) and torch.equal(x61, want[1]), i
    lo, hi = tn.inv_stage_plain(t, 0, x31, x61)
    wlo, whi = jn.inverse_3161(O31, O61, ht, O31.sqr(s31), O61.sqr(s61))
    assert np.array_equal(_u(lo), wlo) and np.array_equal(_u(hi), whi)
    for a in (1, 3):
        got = tn.carry(t, lo, hi, a, t.rounds(a))
        want = jn.carry_3161(np, wlo, whi, ht.widths, ht.masks, a)
        assert np.array_equal(_u(got), want)


def _absorb_needed(lo, hi, w, masks, a):
    """The reference carry's rounds until every carry is 0 or 1 (the
    loop of carry_3161 counted)."""
    d = lo & masks
    c = (lo >> w) | (hi << (np.uint64(64) - w))
    t = d * np.uint64(a)
    c, d = c * np.uint64(a) + (t >> w), t & masks
    k = 0
    while bool((c > 1).any()):
        t = d + np.roll(c, 1)
        c, d = t >> w, t & masks
        k += 1
    return k


@pytest.mark.parametrize("n,a", [(8, 3), (288, 3), (3072, 9)])
def test_carry_reaches_its_static_bound(n, a):
    """Coefficients at the convolution's top (each n (2^wmax - 1)^2) need
    every absorb round DevTables3161.rounds grants before the carries are
    0 or 1 (the reference's loop, counted): the bound is reached, and the
    static carry equals the reference's there."""
    p = _p_for(n)
    ht = jn.build_tables(p, n, np)
    t = tn.DevTables3161.from_host(tn.build_tables(p, n, np), "cpu")
    top = n * ((1 << t.wmax) - 1) ** 2
    lo = np.full(n, top & ((1 << 64) - 1), dtype=np.uint64)
    hi = np.full(n, top >> 64, dtype=np.uint64)
    w = ht.widths
    assert _absorb_needed(lo, hi, w, ht.masks, a) == t.rounds(a)
    want = jn.carry_3161(np, lo, hi, w, ht.masks, a)
    got = tn.carry(t, _t(lo), _t(hi), a, t.rounds(a))
    assert np.array_equal(_u(got), want)


def test_kernel_wrappers_take_the_plain_versions_on_the_cpu():
    """K10-K12's wrappers run in place on CPU tensors (their plain
    versions) and refuse operands of the wrong type or shape and a
    misplaced first/last stage."""
    p = 11213
    t = tn.DevTables3161.from_host(tn.build_tables(p, None, np), "cpu")
    d = _t(_digits(t, 5))
    x31 = torch.zeros((2, t.n), dtype=torch.int32)
    x61 = torch.zeros((2, t.n), dtype=torch.int64)
    want = tn.fwd_stage_plain(t, 0, None, None, d)
    tk.f3_fwd_stage(t, 0, x31, x61, d)
    assert torch.equal(x31, want[0]) and torch.equal(x61, want[1])
    with pytest.raises(ValueError):
        tk.f3_fwd_stage(t, 1, x31, x61, d)
    with pytest.raises(ValueError):
        tk.f3_fwd_stage(t, 1, x31.long(), x61)
    with pytest.raises(ValueError):
        tk.f3_inv_stage(t, 0, x31, x61)
    with pytest.raises(ValueError):
        tk.f3_pointwise(t, x31, x61, x31)
    assert all(tk.calls[k] == 0 for k in ("f3_fwd_stage", "f3_inv_stage",
                                          "f3_pointwise"))


_HOST_LIB = r"""
#include "f3_ntt.cuh"
template <int R> static void fwd(const StageArgs& s) {
    for (long t = 0; t < (long)s.B * s.m; ++t) f3_fwd_item<R>(s, t);
}
template <int R> static void inv(const StageArgs& s) {
    for (long t = 0; t < (long)s.B * s.m; ++t) f3_inv_item<R>(s, t);
}
// prmers_f3_fwd_stage / prmers_f3_inv_stage's arguments (no stream),
// every (block, column) item in turn
extern "C" void host_fwd(u32* x31, u64* x61, const u32* tw31,
                         const u64* tw61, const u32* w31, const u64* w61,
                         int r, int m, int B, int n, const u64* d,
                         u32 a, u32 b, u64 c, u64 e, int f, int g) {
    const StageArgs s = f3_stage_args(x31, x61, tw31, tw61, w31, w61, r, m,
                                      B, n, d, nullptr, nullptr, 0, a, b, c,
                                      e, f, g);
    if (r == 2) fwd<2>(s);
    if (r == 3) fwd<3>(s);
    if (r == 4) fwd<4>(s);
}
extern "C" void host_inv(u32* x31, u64* x61, const u32* tw31,
                         const u64* tw61, const u32* w31, const u64* w61,
                         int r, int m, int B, int n, u64* lo, u64* hi,
                         u64 crt, u32 a, u32 b, u64 c, u64 e, int f, int g) {
    const StageArgs s = f3_stage_args(x31, x61, tw31, tw61, w31, w61, r, m,
                                      B, n, nullptr, lo, hi, crt, a, b, c,
                                      e, f, g);
    if (r == 2) inv<2>(s);
    if (r == 3) inv<3>(s);
    if (r == 4) inv<4>(s);
}
extern "C" void host_pointwise(u32* x31, u64* x61, const u32* m31,
                               const u64* m61, int n) {
    for (long i = 0; i < n; ++i)
        f3_pointwise_item(x31, x61, m31, m61, n, i);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/f3_ntt.cuh built for the host with g++, with the kernels'
    C arguments (ops/kernels.f3_fwd_args, f3_inv_args)."""
    from prmers_tpu_torch.ops import build
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("f3")
    src, lib = d / "host.cpp", d / "libhost.so"
    src.write_text(_HOST_LIB)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    os.path.join(ROOT, "prmers_tpu_torch", "csrc"), str(src),
                    "-o", str(lib)], check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    for name in ("fwd", "inv"):
        argtypes = build.SIGNATURES[f"prmers_f3_{name}_stage"][:-1]
        getattr(h, f"host_{name}").argtypes = argtypes
    h.host_pointwise.argtypes = build.SIGNATURES["prmers_f3_pointwise"][:-1]
    return h


@pytest.mark.parametrize("n", SIZES)
def test_device_bodies_match_plain(host_lib, n):
    """The kernels' per-thread bodies (f3_ntt.cuh: native u32/u64 words,
    mers.cuh's products), run over every item by the host, equal the
    plain versions after every stage and K12, to (lo, hi)."""
    p = _p_for(n)
    t = tn.DevTables3161.from_host(tn.build_tables(p, n, np), "cpu")
    d = _t(_digits(t, 3 * n))
    x31 = torch.zeros((2, n), dtype=torch.int32)
    x61 = torch.zeros((2, n), dtype=torch.int64)
    h31, h61 = x31.clone(), x61.clone()
    for i in range(len(t.stages)):
        di = d if i == 0 else None
        tk.f3_fwd_stage(t, i, x31, x61, di)
        host_lib.host_fwd(*tk.f3_fwd_args(t, i, h31, h61, di))
        assert torch.equal(x31, h31) and torch.equal(x61, h61), i
    m31, m61 = x31.clone(), x61.clone()
    for m in ((m31, m61), (None, None)):
        tk.f3_pointwise(t, x31, x61, *m)
        host_lib.host_pointwise(h31.data_ptr(), h61.data_ptr(),
                                *[tk._ptr(v) for v in m], n)
        assert torch.equal(x31, h31) and torch.equal(x61, h61)
    lo, hi = torch.zeros(n, dtype=torch.int64), torch.zeros(n,
                                                           dtype=torch.int64)
    hl, hh = lo.clone(), hi.clone()
    for i in range(len(t.stages) - 1, -1, -1):
        last = i == 0
        tk.f3_inv_stage(t, i, x31, x61, *((lo, hi) if last else ()))
        host_lib.host_inv(*tk.f3_inv_args(t, i, h31, h61,
                                          *((hl, hh) if last else ())))
        assert torch.equal(x31, h31) and torch.equal(x61, h61), i
    assert torch.equal(lo, hl) and torch.equal(hi, hh)


def test_dev_tables_layout():
    """DevTables3161 holds each stage's (2, r, m) twiddles with B blocks,
    the M31 plane int32 and the M61 plane int64, equal to the host
    tables."""
    ht = tn.build_tables(11213, None, np)
    t = tn.DevTables3161.from_host(ht, "cpu")
    assert [(s.r, s.L, s.m, s.B) for s in t.stages] == [
        (3, 288, 96, 1), (3, 96, 32, 3), (2, 32, 16, 9), (4, 16, 4, 18),
        (4, 4, 1, 72)]
    for s, (r, tw, twi) in zip(t.stages, ht.p61.stages):
        assert s.tw61.dtype == torch.int64 and s.tw31.dtype == torch.int32
        assert np.array_equal(_u(s.tw61.reshape(-1)),
                              np.concatenate([tw[0].ravel(), tw[1].ravel()]))
        assert np.array_equal(_u(s.twi61.reshape(-1)),
                              np.concatenate([twi[0].ravel(),
                                              twi[1].ravel()]))
    assert (t.wmin, t.wmax) == (int(ht.widths.min()), int(ht.widths.max()))
    assert dataclasses.is_dataclass(t)
