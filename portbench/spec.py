"""Finds what a cell is made of by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each lives in a file of its own, found by name:

  configs/<file named by the configuration's entry>   sizes, index, search
  traffic/<traffic>.json                               a mix's parameters
  traffic/<kind>.py                                    the loop of a kind
  limits/<cell>.json                                   what ``correct`` holds
  metrics/<metric>.py                                  a metric's reader

so a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents (with "name")
    limits: dict          # the cell's limits file
    end_to_end: List[dict]
    per_layer: List[dict]


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` is read in those cells. Without it, an
    end-to-end metric is read in every cell, and a per-layer metric in
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"one of {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


_modules: Dict[Path, ModuleType] = {}


def _module(path: Path, what: str) -> ModuleType:
    """The file ``path`` as a module (names may hold dots, so it is
    loaded from its path), loaded once."""
    mod = _modules.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no {what}: {path}")
        name = "portbench._" + "_".join(
            path.relative_to(HERE).with_suffix("").parts).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return mod


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``. It defines ``read(run) -> float | None``
    and may define ``probe(run)``, called while the program is alive."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   f"reader for metric {metric!r}")


def traffic_kind(kind: str) -> type:
    """The ``Traffic`` class of ``traffic/<kind>.py`` (a ``loops.Loop``)."""
    return _module(HERE / "traffic" / f"{kind}.py",
                   f"traffic kind {kind!r}").Traffic


def read_all(metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def probe_all(metrics: List[dict], run) -> None:
    for m in metrics:
        probe = getattr(reader(m["name"]), "probe", None)
        if probe is not None:
            probe(run)
