"""Tests of the benchmark (CPU; the cases marked ``gpu`` need a CUDA card
and skip without one, decided inside the ``cuda`` fixture)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def merged_benchmark() -> dict:
    """BENCHMARK.json with the cells of ``candidates.json`` added: a
    metric named in both gets the union of their ``workloads``."""
    import copy

    from portbench import spec

    bench = copy.deepcopy(spec.benchmark())
    cand = spec.load_json(spec.HERE / "tests" / "candidates.json")
    bench["configs"] += cand["configs"]
    bench["workloads"] += cand["workloads"]
    for key in ("end_to_end", "per_layer"):
        by_name = {m["name"]: m for m in bench[key]}
        for m in cand[key]:
            if m["name"] in by_name:
                by_name[m["name"]]["workloads"] += m["workloads"]
            else:
                bench[key].append(dict(m))
    return bench


@pytest.fixture
def candidates(monkeypatch):
    """The loader sees the candidate cells beside BENCHMARK.json's."""
    from portbench import spec

    merged = merged_benchmark()
    monkeypatch.setattr(spec, "benchmark", lambda root=spec.ROOT: merged)
    return merged
