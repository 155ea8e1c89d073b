"""Whole runs of every cell and candidate cell, on the CPU at the
rehearsal sizes (the chip's look skipped by ``--rehearse``): a sound run
is correct; the control (the reference in TF32) and each fault a cell can
have, planted under the timed path, come out not correct."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from alayalite_tpu_torch.index.engine import IndexEngine
from alayalite_tpu_torch.serving import SearchServer
from portbench import run as runmod
from portbench.spec import ROOT

CELLS = ["bsq8-batch", "raw-batch", "bsq8-served", "bsq8-churn"]
pytestmark = pytest.mark.usefixtures("candidates")


def _run(capsys, cell, *extra, seed=3000000007, seconds=2):
    rc = runmod.main(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", "0", "--rehearse", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(capsys, cell):
    res = _run(capsys, cell)
    assert res["correct"] is True, res["compared"]
    assert list(res)[-1] == "compared"
    assert res["device"]["platform"] == "cpu"
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(capsys, cell):
    res = _run(capsys, cell, "--control")
    assert res["correct"] is False
    assert res["compared"]["order_gap"]["value"] > 2e-4


def _alter_first_answer(monkeypatch):
    orig = IndexEngine._batch_search_impl

    def altered(self, *a, **k):
        i, d = orig(self, *a, **k)
        i = i.clone()
        i[0] = i[0].roll(1)
        return i, d

    monkeypatch.setattr(IndexEngine, "_batch_search_impl", altered)


def _drop_half(monkeypatch):
    orig = IndexEngine._batch_search_impl

    def half(self, *a, **k):
        i, d = orig(self, *a, **k)
        i, d = i.clone(), d.clone()
        i[i.shape[0] // 2:] = -1
        d[d.shape[0] // 2:] = float("inf")
        return i, d

    monkeypatch.setattr(IndexEngine, "_batch_search_impl", half)


def _misroute(monkeypatch):
    orig = SearchServer._search

    def rolled(self, batch):
        ids, d = orig(self, batch)
        return np.roll(ids, 1, 0), np.roll(d, 1, 0)

    monkeypatch.setattr(SearchServer, "_search", rolled)


def _insert_unchanged(monkeypatch):
    def insert(self, vectors, ef=100, _capture=True):
        n = np.atleast_2d(vectors).shape[0]
        return np.arange(self.space.num, self.space.num + n, dtype=np.int32)

    monkeypatch.setattr(IndexEngine, "insert", insert)


def _remove_unchanged(monkeypatch):
    monkeypatch.setattr(IndexEngine, "remove", lambda self, ids: None)


FAULTS = [("bsq8-batch", _alter_first_answer), ("bsq8-batch", _drop_half),
          ("raw-batch", _alter_first_answer), ("raw-batch", _drop_half),
          ("bsq8-served", _alter_first_answer), ("bsq8-served", _drop_half),
          ("bsq8-served", _misroute),
          ("bsq8-churn", _insert_unchanged), ("bsq8-churn", _remove_unchanged),
          ("bsq8-churn", _alter_first_answer)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in FAULTS])
def test_fault_is_not_correct(capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = _run(capsys, cell)
    assert res["correct"] is False, res["compared"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", "bsq8-batch", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "bsq8-batch", "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--rehearse"],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
