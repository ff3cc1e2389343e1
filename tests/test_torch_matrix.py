"""The port's backend validation matrix
(prmers_tpu_torch/tools/validation_matrix.py) on the CPU with a stubbed
case list (PRMERS_PLATFORM=cpu): the columns each case runs (no fft3161
column for ECM, no pallas column off the card), the TSV, the exit code 0
when every column agrees and 1 on a forced mismatch or a column that
raises, and the stop with an error where there is no card and the CPU was
not asked for."""

import pytest

from prmers_tpu_torch import app as tapp
from prmers_tpu_torch.tools import validation_matrix as tvm

CASES = [("prp", dict(exponent=127, mode="prp", proof=False)),
         ("ecm_edwards", dict(exponent=37, mode="ecm", b1=20, b2=400,
                              curves=6, curve_seed=5))]


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setenv("PRMERS_PLATFORM", "cpu")
    monkeypatch.delenv("PRMERS_ECM_NO_BATCH", raising=False)
    monkeypatch.setattr(tvm, "cases", lambda profile: iter(CASES))


def _tsv(path) -> list[list[str]]:
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f]


def test_matrix_columns_and_tsv(stubbed, tmp_path, capsys):
    out = tmp_path / "summary.tsv"
    assert tvm.main(["quick", str(out)]) == 0
    rows = _tsv(out)
    assert rows[0] == ["case", "backend", "outcome", "seconds"]
    assert [r[:2] for r in rows[1:]] == [
        ["prp", "numpy/gl64"], ["prp", "jax/gl64"], ["prp", "numpy/fft3161"],
        ["ecm_edwards", "numpy/gl64"], ["ecm_edwards", "jax/gl64"]]
    assert {r[2] for r in rows[1:4]} == {
        "is_prime=True,res64=0000000000000001"}
    assert {r[2] for r in rows[4:]} == {"factor=223"}
    assert all(float(r[3]) >= 0 for r in rows[1:])
    assert "OK: 5 runs, 0 mismatched cases" in capsys.readouterr().out


@pytest.mark.parametrize("how", ["differs", "raises"])
def test_matrix_mismatch_exit_code(how, stubbed, monkeypatch, tmp_path,
                                   capsys):
    """One column forced off the others' outcome (a wrong res64, or an
    exception): the case counts as mismatched and the exit code is 1."""
    real = tapp.run

    def run(opts, device=None, log=print, gui=None):
        r, j = real(opts, device=device, log=log)
        if opts.backend == "jax" and opts.mode == "prp":
            if how == "raises":
                raise RuntimeError("forced")
            r.res64 = "0000000000000002"
        return r, j
    monkeypatch.setattr(tapp, "run", run)
    out = tmp_path / "summary.tsv"
    assert tvm.main(["quick", str(out)]) == 1
    jax_prp = [r for r in _tsv(out) if r[:2] == ["prp", "jax/gl64"]]
    want = "ERROR:RuntimeError:forced" if how == "raises" else \
        "is_prime=True,res64=0000000000000002"
    assert [r[2] for r in jax_prp] == [want]
    cap = capsys.readouterr()
    assert "MISMATCH in prp" in cap.err
    assert "FAIL: 5 runs, 1 mismatched cases" in cap.out


def test_matrix_pallas_column_skips_uncovered_plans(stubbed, monkeypatch,
                                                   tmp_path, capsys):
    """The pallas column runs only the cases whose plan the four-step
    engine takes: both stubbed cases (n = 8) are skipped and said so,
    never recorded, and the exit code stays 0; p = 544139 (n = 2^15) is
    taken."""
    monkeypatch.setattr(tvm, "backends", lambda: [
        ("numpy", "gl64"), ("jax", "gl64"), ("numpy", "fft3161"),
        ("pallas", "gl64")])
    out = tmp_path / "summary.tsv"
    assert tvm.main(["quick", str(out)]) == 0
    assert not [r for r in _tsv(out) if r[1] == "pallas/gl64"]
    said = [ln for ln in capsys.readouterr().out.splitlines()
            if "pallas/gl64" in ln]
    assert len(said) == 2 and all("skipped" in ln for ln in said)
    assert tvm.pallas_takes(544139) and not tvm.pallas_takes(9941)


def test_matrix_needs_a_card_or_the_cpu_asked(monkeypatch):
    """No card and no PRMERS_PLATFORM=cpu: the matrix stops with an error
    instead of dropping the card's columns; on a card it adds pallas."""
    import torch
    monkeypatch.delenv("PRMERS_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="PRMERS_PLATFORM=cpu"):
        tvm.main(["quick"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tvm.backends()[-1] == ("pallas", "gl64")
    monkeypatch.setenv("PRMERS_PLATFORM", "cpu")
    assert ("pallas", "gl64") not in tvm.backends()
