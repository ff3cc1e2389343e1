"""BENCHMARK.json against the rules of its format, and the harness finding a
new configuration, traffic mix and metric by their files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [e["name"] for e in bench["configs"] + bench["workloads"]
             + metrics]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_command_and_paths(bench):
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    for path in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", path)
        assert (spec.ROOT / path).is_dir()
        assert not path.endswith("_torch")


def test_configs(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
        with open(spec.ROOT / c["file"]) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        lo, hi = data["exponent_band"]
        assert lo < hi


def test_every_cell_resolves(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
        for m in cell.end_to_end + cell.per_layer:
            assert run.metric_path(m["name"]).is_file(), m["name"]


def test_exponent_is_drawn_from_the_seed(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        lo, hi = cell.config["exponent_band"]
        ps = [spec.exponent(cell.config, cell.traffic, s)
              for s in (1, 2, 2**31 + 11, 2**40 + 3)]
        assert ps[0] == spec.exponent(cell.config, cell.traffic, 1)
        assert len(set(ps)) == len(ps)
        for p in ps:
            assert lo <= p <= hi and spec.is_prime(p)
            share = cell.traffic.get("first_block_share")
            if share:
                b = spec.first_block(p) / (p ** 0.5 // 1)
                assert share[0] <= b < share[1]


def test_band_takes_one_plan(bench):
    """Every exponent the seeds draw gets the configuration's plan."""
    from prmers_tpu_torch.core.plan import cached_plan
    from prmers_tpu_torch.ops import fourstep as tfs
    for c in bench["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        lo, hi = cfg["exponent_band"]
        for p in (lo, hi, (lo + hi) // 2):
            fp = tfs.FourStepPlan.from_plan(cached_plan(p), tfs.Pipeline())
            assert (fp.rs.L1, fp.rs.L2, fp.C) == (
                cfg["plan"]["R1"], cfg["plan"]["R2"], cfg["plan"]["C"])
            assert fp.n == cfg["plan"]["n"]
            assert tfs.carry_ct(fp) == fp.C // cfg["plan"]["T"]
            assert tfs.carry_rounds(fp) == 3


def test_new_cell_by_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and BENCHMARK.json entries are found, with no code edited."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    cfg = {"name": "tiny", "exponent_band": [9000, 12000],
           "plan": {"n": 512, "R1": 8, "R2": 8, "C": 8, "T": 1},
           "reduced": []}
    (tmp_path / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((spec.BENCH_DIR / "traffic/prp.json").read_text())
    traffic["cli"] = ["-checklevel", "2"]
    (tmp_path / "benchmark/traffic/burst.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/metrics/squarings_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['squarings']['all'])\n")
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.burst", "config": "tiny",
                               "traffic": "burst", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "squarings_seen", "unit": "sq",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "kernel wrappers (ops/kernels.py)",
                               "moves": "prp_iter_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "from benchmark import spec, run\n"
        "cell = spec.load_cell('tiny.burst')\n"
        "assert cell.traffic['cli'] == ['-checklevel', '2']\n"
        "names = [m['name'] for m in cell.per_layer]\n"
        "assert 'squarings_seen' in names, names\n"
        "ctx = {'squarings': {'all': 7}, 'calls': {}, 'trace': None,\n"
        "       'plan': cell.config['plan'], 'card': None}\n"
        "assert 'prp_iter_s' in [m['name'] for m in cell.end_to_end]\n"
        "print(run.read_metrics(cell.per_layer, ctx))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{spec.ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "'squarings_seen': {'value': 7.0, 'unit': 'sq'}" in out.stdout
