"""Runs of a tiny cell on the CPU (the port's plain kernels, the any-size
engine at n = 512), past the harness's look for a card: correct on the
sound program, not correct with the timed path broken underneath."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import judge, run, spec
from prmers_tpu_torch.engine.factory import create_engine

CONFIG = {"name": "tiny", "exponent_band": [9000, 12000],
          "plan": {"n": 512, "R1": 8, "R2": 8, "C": 8, "T": 1}}


def _cell(traffic_name, **over):
    traffic = json.loads(
        (spec.BENCH_DIR / "traffic" / f"{traffic_name}.json").read_text())
    traffic["first_block_share"] = None
    traffic.update(over)
    bench = spec.load_benchmark()
    return spec.Cell(name=f"tiny.{traffic_name}", config=CONFIG,
                     traffic=traffic, chips=1,
                     end_to_end=tuple(bench["end_to_end"]),
                     per_layer=tuple(bench["per_layer"]))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, seed=12345, seconds=1.0, make_engine=None, trace=False):
    return run.run_cell(cell, seed, seconds, trace, device="cpu",
                        make_engine=make_engine)


def test_sound_run_is_correct():
    res = _run(_cell("prp"))
    assert judge.correct(res["checks"]), res["checks"]
    assert res["attempted"] > 100 and res["failed"] == 0
    b = spec.first_block(res["p"])
    assert res["squarings"]["replay"] == 0
    assert res["attempted"] > b    # the window passed a block boundary
    cell = _cell("prp")
    e2e = run.read_metrics(cell.end_to_end, run.metric_context(cell, res,
                                                               None))
    assert e2e["prp_iter_s"]["value"] == res["attempted"] / res["window_s"]
    assert e2e["setup_s"]["value"] == res["setup_s"] > 0


def test_check_traffic_is_correct_and_counts_replays():
    res = _run(_cell("prp_check"), seconds=1.5)
    assert judge.correct(res["checks"]), res["checks"]
    assert res["gl"]["passed"] >= 1 and res["squarings"]["replay"] > 0


def test_traced_run_on_the_cpu_reads_counters_only():
    cell = _cell("prp")
    res = _run(cell, trace=True)
    assert judge.correct(res["checks"])
    layer = run.read_metrics(cell.per_layer,
                             run.metric_context(cell, res, None))
    # no device on the CPU: at most the program's counter has something
    assert set(layer) <= {"launches_per_sq"}


def _broken(fault):
    def make(p, regs, **kw):
        eng = create_engine(p, regs, **kw)
        orig = eng.square_mul_seq

        def square_mul_seq(src, a_vec):
            if fault == "unchanged":
                return None
            orig(src, a_vec)
            if fault == "altered" and src == 0:
                eng.add_small(0, 1)
        eng.square_mul_seq = square_mul_seq
        return eng
    return make


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_broken_program_is_not_correct(fault):
    res = _run(_cell("prp"), make_engine=_broken(fault))
    assert not judge.correct(res["checks"]), res["checks"]
    assert res["checks"]["r0_words_off"]["value"] > 0


def test_failed_check_is_counted_and_not_correct():
    """An error injected by the PRP driver's own -erroriter: its check fails
    and rolls back; the iterations lost count as failed."""
    res = _run(_cell("prp_check", cli=["-checklevel", "1",
                                       "-erroriter", "20"]), seconds=3.0)
    assert res["gl"]["failed"] == 1 and res["failed"] > 0
    assert res["checks"]["r0_words_off"]["value"] == 0
    assert res["checks"]["gl_checks_failed"]["value"] == 1
    assert not judge.correct(res["checks"])


def test_check_outcomes_parse():
    lines = ["[Gerbicz Li] Check passed! iter=95",
             "[Gerbicz Li] Mismatch",
             "[Gerbicz Li] Check FAILED! iter=285",
             "[Gerbicz Li] Restore iter=94 (j=100)",
             "[Gerbicz Li] Check passed! iter=190"]
    assert run.check_outcomes(lines) == {"passed": 2, "failed": 1,
                                         "rolled_back": 190}


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "wavefront.prp", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "wavefront.prp", "--seed", "77", "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["prp_iter_s"]["value"] > 0
