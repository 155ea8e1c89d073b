"""The port's copies of the ann-benchmarks adapter and the examples, on
the CPU: the adapter fits and answers like the JAX package's adapter, the
RAG helpers store and retrieve a chunk, the quickstart runs."""

import importlib.util
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_annbenchmark_adapter_matches_jax_adapter():
    from adapters.annbenchmark.alayalite_tpu.module import AlayaLiteTPU
    from adapters.annbenchmark.alayalite_tpu_torch.module import (
        AlayaLiteTPUTorch)

    rng = np.random.default_rng(4)
    x = rng.normal(size=(600, 16)).astype(np.float32)
    ours = AlayaLiteTPUTorch("euclidean", {"index_type": "flat",
                                           "device": "cpu"})
    theirs = AlayaLiteTPU("euclidean", {"index_type": "flat"})
    for algo in (ours, theirs):
        algo.fit(x)
        algo.set_query_arguments(32)
        algo.batch_query(x[:20], 5)
    np.testing.assert_array_equal(ours.get_batch_results(),
                                  theirs.get_batch_results())
    assert (ours.get_batch_results()[:, 0] == np.arange(20)).all()
    assert ours.query(x[7], 3)[0] == 7
    assert str(ours).startswith("alayalite_tpu_torch(flat")


def test_rag_example_db(monkeypatch):
    monkeypatch.setenv("ALAYALITE_DEVICE", "cpu")
    spec = importlib.util.spec_from_file_location(
        "rag_torch_db", os.path.join(ROOT, "examples", "rag_torch", "db.py"))
    db = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(db)
    n = db.insert_text("The eiffel tower is in paris. Bananas are yellow "
                       "fruit. The moon orbits the earth.")
    assert n >= 1
    assert "eiffel" in db.query_text("where is the eiffel tower?", topk=1)[0]
    assert db.get_client().device.type == "cpu"


def test_quickstart_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_quickstart.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    assert "recall@10 = " in out.stdout
    top1 = out.stdout.split("top-1 ids  = ")[1].strip()
    assert top1 == str(list(range(10)))
