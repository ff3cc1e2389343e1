"""The plain reference against Python's pow, its control, and the
modules it loads."""

import math
import re
import subprocess
import sys

import numpy as np
import pytest

from benchmark import judge, reference, run, spec


def _direct(p, k):
    m = (1 << p) - 1
    b = math.isqrt(p)
    first = p % b or b
    x, acc = 3, 1
    for i in range(1, k + 1):
        x = x * x % m
        if i >= first and (i - first) % b == 0:
            acc = acc * x % m
    return x, acc


@pytest.mark.parametrize("p,k", [(127, 40), (521, 100), (4253, 200),
                                 (9941, 300), (86243, 350)])
def test_reference_matches_pow(p, k):
    r0, r1, err = reference.prp_state(p, k, "cpu")
    assert (r0, r1) == _direct(p, k)
    assert err < 0.05


@pytest.mark.parametrize("p,lengths", [(9941, (768, 1024, 1280)),
                                       (86243, (6144, 8192, 10240))])
def test_reference_at_other_lengths(p, lengths):
    """Radix-3, radix-2 and radix-5 lengths give the same values."""
    want = reference.prp_state(p, 60, "cpu")[:2]
    for n in lengths:
        assert reference.prp_state(p, 60, "cpu", n=n)[:2] == want


def test_transform_length():
    assert reference.transform_length(136279841) == 1 << 23
    assert reference.transform_length(139999981) == 1 << 23
    assert reference.transform_length(332192831) == 5 << 22
    assert reference.transform_length(333000000) == 5 << 22


def test_pack_unpack_words_off():
    rng = np.random.default_rng(5)
    widths = np.diff(reference.digit_positions(4253, 256))
    for _ in range(5):
        v = int(rng.integers(0, 2**62)) << 4000 | int(rng.integers(0, 2**62))
        d = reference.unpack(v, widths)
        assert int(d.max()) < 1 << int(widths.max())
        assert reference.pack(d, widths) == v
    assert reference.words_off(5, 5, 4253) == 0
    assert reference.words_off(5, 4, 4253) == 1
    assert reference.words_off(1 << 4200 | 1, 0, 4253) == 2


def test_control_fails_the_comparison():
    """The reference in float32, put in the program's place, at a
    four-step plan's size (p = 756839, n = 2^15 for the program)."""
    cell = spec.Cell(name="t", config={"exponent_band": [756839, 756839]},
                     traffic={"first_block_share": None}, chips=1,
                     end_to_end=(), per_layer=())
    from benchmark import control
    r = control.readings(cell, 3, "cpu")
    assert r["p"] == 756839
    assert r["check"]["r0_words_off"] > 1000
    assert r["check"]["r1_words_off"] > 1000
    assert not r["correct"] and r["rounding_error"] < 0.05


def test_judge_limits():
    p = 127
    widths = np.diff(reference.digit_positions(p, 8))
    r0, r1 = _direct(p, 30)
    prog = {"r0": reference.unpack(r0, widths),
            "r1": reference.unpack(r1, widths)}
    ok = judge.compare(p, prog, widths, r0, r1, {"failed": 0})
    assert judge.correct(ok)
    bad = judge.compare(p, prog, widths, r0 ^ 1, r1, {"failed": 0})
    assert bad["r0_words_off"]["value"] == 1 and not judge.correct(bad)
    assert not judge.correct(judge.compare(p, prog, widths, r0, r1,
                                           {"failed": 1}))


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "prmers_tpu_torch_fake.sub", sys)
    assert "prmers_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "prmers_tpu.fake", sys)
    assert "prmers_tpu" in run.loaded_forbidden()


def test_reference_loads_no_port_and_no_jax():
    code = ("import sys, benchmark.reference, benchmark.judge, "
            "benchmark.yardstick, benchmark.control\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(top & {'jax', 'jaxlib', 'flax', 'prmers_tpu', "
            "'prmers_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_harness_sources_import_no_jax():
    """No file of the benchmark imports jax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|prmers_tpu)"
                     r"(\.|\s|$)", re.M)
    for path in spec.BENCH_DIR.rglob("*.py"):
        assert not pat.search(path.read_text()), path


@pytest.mark.gpu
def test_control_on_the_card(card):
    """The control at wavefront.prp's own size on the card."""
    from benchmark import control
    r = control.readings(spec.load_cell("wavefront.prp"), 7, "cuda",
                         squarings=200)
    assert not r["correct"] and r["rounding_error"] < 0.25
