"""The port's copies of the host modules (prmers_tpu_torch/core, io, modes,
utils, engine/api) against the JAX package's originals: the same plans and
digit widths, the same result JSON and checkpoint bytes, the same CLI
parse, and the same PRP/LL verdicts and residues on one reference engine.
Users move checkpoints and results between the two packages, so these
formats must stay byte-identical."""

import dataclasses

import numpy as np
import pytest

from prmers_tpu.core import checkpoints as jck
from prmers_tpu.core import plan as jplan
from prmers_tpu.engine.np_engine import NumpyEngine
from prmers_tpu.io import cli as jcli
from prmers_tpu.io import json_out as jjson
from prmers_tpu.io import worktodo as jwt
from prmers_tpu.io.options import Options as JOptions
from prmers_tpu.modes import prp_ll as jprp
from prmers_tpu_torch.core import checkpoints as tck
from prmers_tpu_torch.core import plan as tplan
from prmers_tpu_torch.io import cli as tcli
from prmers_tpu_torch.io import json_out as tjson
from prmers_tpu_torch.io import worktodo as twt
from prmers_tpu_torch.io.options import Options as TOptions
from prmers_tpu_torch.modes import prp_ll as tprp

PLAN_PS = [756839, 1257787, 2976221, 4325377, 9999991, 136279841, 600000001,
           1000000007]


@pytest.mark.parametrize("p", PLAN_PS)
def test_plans_equal(p):
    for build in ("build_plan", "cached_plan"):
        a = getattr(jplan, build)(p)
        b = getattr(tplan, build)(p)
        assert (a.n, a.R, a.C, a.w, a.inv_n) == (b.n, b.R, b.C, b.w, b.inv_n)
        assert a.radixes_r == b.radixes_r and a.radixes_c == b.radixes_c
        assert np.array_equal(a.freq_r, b.freq_r)
        assert a.widths.dtype == b.widths.dtype
        assert np.array_equal(a.widths, b.widths)
    for mod in (jplan, tplan):
        mod.cached_plan.cache_clear()


def test_result_json_equal():
    kw = dict(exponent=756839, worktype="PRP-3", status="P",
              res64="0000000000000001", res2048="AB" * 8, gerbicz_errors=1,
              fft_length=32768, known_factors=("1234567",), user="u",
              computer="c", aid="0" * 32, timestamp="2026-01-02 03:04:05")
    assert jjson.build_result_json(**kw) == tjson.build_result_json(**kw)
    kw.update(worktype="LL", status="C", known_factors=())
    assert jjson.build_result_json(**kw) == tjson.build_result_json(**kw)


def test_checkpoint_bytes_equal(tmp_path):
    rng = np.random.default_rng(7)
    fields = dict(p=756839, mode_tag=1, iteration=12345, elapsed=6.5,
                  extra=rng.bytes(28), regs=rng.bytes(4096))
    a, b = str(tmp_path / "a" / "m.ckpt"), str(tmp_path / "b" / "m.ckpt")
    jck.write_checkpoint(a, jck.CheckpointData(**fields))
    tck.write_checkpoint(b, tck.CheckpointData(**fields))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got = tck.read_checkpoint(a, 756839, 1)
    assert dataclasses.asdict(got) == fields
    assert tck.ckpt_filename(9, "ll", True, "d") == \
        jck.ckpt_filename(9, "ll", True, "d")


@pytest.mark.parametrize("argv", [["756839", "-noproof"],
                                  ["1277", "-ll", "-t", "30"],
                                  ["127", "-prp", "-wagstaff"]])
def test_cli_parse_equal(argv):
    assert dataclasses.asdict(jcli.parse_args(argv)) == \
        dataclasses.asdict(tcli.parse_args(argv))


def _opts(cls, p, tmp_path, mode):
    return cls(exponent=p, save_dir=str(tmp_path), proof=False,
               verbose=False, backup_interval=1e9, mode=mode)


@pytest.mark.parametrize("p,mode", [(127, "ll"), (1277, "ll"),
                                    (521, "prp"), (1009, "prp")])
def test_run_prp_or_ll_equal(p, mode, tmp_path):
    """tests/test_prp_ll.py's small runs through both drivers, each on a
    fresh reference engine of the JAX package (the host oracle)."""
    quiet = lambda *a, **k: None  # noqa: E731
    rj = jprp.run_prp_or_ll(_opts(JOptions, p, tmp_path / "j", mode),
                            eng=NumpyEngine(p, 8), log=quiet)
    rt = tprp.run_prp_or_ll(_opts(TOptions, p, tmp_path / "t", mode),
                            eng=NumpyEngine(p, 8), log=quiet)
    assert (rt.is_prime, rt.res64, rt.res2048, rt.gerbicz_errors) == \
        (rj.is_prime, rj.res64, rj.res2048, rj.gerbicz_errors)
    assert rt.is_prime == (p in (127, 521))


def test_worktodo_is_the_original(tmp_path):
    """io/worktodo.py is the JAX package's, word for word (it imports the
    standard library only), and both write the same results files and
    parse the same entries."""
    with open(jwt.__file__) as a, open(twt.__file__) as b:
        assert a.read() == b.read()
    line = '{"exponent": 127, "status": "P"}'
    for mod, d in ((jwt, tmp_path / "j"), (twt, tmp_path / "t")):
        d.mkdir()
        mod.append_results_txt(str(d / "results.txt"), line + "\n")
        mod.append_results_txt(str(d / "results.txt"), line)
        assert mod.write_individual_json(str(d), 127, "prp", line) == \
            str(d / "127_prp_result.json")
    for name in ("results.txt", "127_prp_result.json"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes()
    for text in ("PRP=1,2,756839,-1", "Test=1277", "ECM2=1,2,1277,-1,5,6,7",
                 'PRP=1,2,1277,-1,75,0,"3"'):
        assert dataclasses.asdict(jwt.parse_line(text)) == \
            dataclasses.asdict(twt.parse_line(text))


# The port's copies of JAX-package modules that differ from their original
# in more than imports: the definitions each copy changes, drops or adds,
# as its header ("Port: ...") lists them. Everything else is the original's.
COPIES = {
    "core/field.py": {},
    "modes/llsafe.py": {},
    "engine/np_engine.py": {"changed": {"NumpyEngine._carry"}},
    "ops/ntt.py": {"dropped": {"_register_pytrees", "<_register_pytrees()>"},
                   "added": {"NttTables.to_device"}},
    "core/proof.py": {"changed": {"ProofSet.checkpoint",
                                  "ProofSet._write_shards"}},
    "utils/primes.py": {},
    "ui/webgui.py": {},
    "io/interop.py": {},
    "io/p95.py": {},
    "modes/memtest.py": {"changed": {"run_memtest"}},
    "modes/bench.py": {"changed": {"_bench_one", "run_bench"}},
    "modes/pm1.py": {"changed": {
        "run_pm1_stage1", "run_pm1_stage2", "_load_stage1_x",
        "run_pm1_stage2_lowmem", "run_pm1_stage2_ultralow",
        "run_pm1_stage2_nk", "run_pm1_stage2_vtrace", "run_pm1"}},
    "modes/ecm.py": {"changed": {"_backtrack_single", "_run_ecm_batch",
                                 "run_ecm"}},
    "modes/ecm_edwards.py": {"changed": {
        "_backtrack_single_ed", "_run_edwards_batch", "run_ecm_edwards"}},
    "engine/paged.py": {"changed": {"device_reg_budget"},
                        "added": {"OVERHEAD_BYTES", "register_bytes",
                                  "free_device_bytes"}},
    "engine/policy.py": {"changed": {"_GL64_ENGINES", "decide_arith"}},
    "core/tune.py": {"changed": {"TUNE_FILE", "run_tune"}},
    "core/profile.py": {"changed": {"ProfiledEngine", "ProfiledEngine._OPS"},
                        "added": {"ProfiledEngine.addsub"}},
}


def _definitions(path):
    """{name: ast dump} of a module's functions, methods, classes (without
    their methods), assignments to one name and other top-level
    statements, imports and the module docstring left out."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}

    def visit(body, prefix):
        for node in body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            if isinstance(node, ast.ClassDef):
                visit(node.body, prefix + node.name + ".")
                rest = [b for b in node.body if not isinstance(
                    b, (ast.FunctionDef, ast.AsyncFunctionDef))]
                out[prefix + node.name] = ast.dump(ast.ClassDef(
                    name=node.name, bases=node.bases, keywords=node.keywords,
                    body=rest, decorator_list=node.decorator_list))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[prefix + node.name] = ast.dump(node)
            elif (isinstance(node, ast.Assign) and len(node.targets) == 1
                  and isinstance(node.targets[0], ast.Name)):
                out[prefix + node.targets[0].id] = ast.dump(node)
            elif not (prefix == "" and node is tree.body[0]
                      and isinstance(node, ast.Expr)):
                src = ast.unparse(node)
                out[f"<{src}>" if len(src) < 40 else ast.dump(node)] = \
                    ast.dump(node)

    visit(tree.body, "")
    return out


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copies_are_the_originals(rel):
    """Each copy equals its original definition by definition (the ast,
    so the imports may differ), except the definitions its header lists
    as changed, dropped or added."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    a = _definitions(os.path.join(root, "prmers_tpu", rel))
    b = _definitions(os.path.join(root, "prmers_tpu_torch", rel))
    spec = COPIES[rel]
    assert set(a) - set(b) == spec.get("dropped", set())
    assert set(b) - set(a) == spec.get("added", set())
    differ = {k for k in set(a) & set(b) if a[k] != b[k]}
    assert differ == spec.get("changed", set())
    with open(os.path.join(root, "prmers_tpu_torch", rel)) as f:
        head = f.read(4000)
    assert ("Port: a copy of prmers_tpu/" + rel in head) == bool(spec)


# ops/mxu_tables.py copies part of prmers_tpu/ops/pallas/mxu_dft.py (the
# host-side table builders): the definitions it takes as they are, and
# those its header lists as changed
MXU_COPIED = ("_plane_offset", "N_WPLANES", "_MAXPOS8", "_balanced_limbs",
              "_balanced_limbs_vec", "_fold_sub_into_corr")
MXU_CHANGED = ("_mulmod_u64", "build_mxu_tables")


@pytest.mark.parametrize("name", MXU_COPIED + MXU_CHANGED)
def test_mxu_tables_copies_are_the_originals(name):
    """Each copied builder equals the original's definition (the ast);
    each changed one differs, as the header says."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    a = _definitions(os.path.join(root, "prmers_tpu", "ops", "pallas",
                                  "mxu_dft.py"))
    b = _definitions(os.path.join(root, "prmers_tpu_torch", "ops",
                                  "mxu_tables.py"))
    assert (a[name] == b[name]) == (name in MXU_COPIED)
    with open(os.path.join(root, "prmers_tpu_torch", "ops",
                           "mxu_tables.py")) as f:
        head = f.read(4000)
    assert "Port: a copy of the host-side table builders of prmers_tpu/" \
           "ops/pallas/\nmxu_dft.py" in head
    assert name in head or name in ("N_WPLANES", "_MAXPOS8")


def test_matrix_cases_and_fingerprint_are_the_originals():
    """The port's validation matrix (prmers_tpu_torch/tools/
    validation_matrix.py) runs the reference's cases
    (tools/validation_matrix.py) and compares by its fingerprint: both
    definitions equal the originals', and the cases of both profiles are
    the same values."""
    import importlib.util
    import os
    from prmers_tpu_torch.tools import validation_matrix as tvm
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref_path = os.path.join(root, "tools", "validation_matrix.py")
    a = _definitions(ref_path)
    b = _definitions(tvm.__file__)
    for name in ("cases", "fingerprint"):
        assert a[name] == b[name], name
    spec = importlib.util.spec_from_file_location("_ref_matrix", ref_path)
    jvm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jvm)
    for profile in ("quick", "standard"):
        assert list(tvm.cases(profile)) == list(jvm.cases(profile))
