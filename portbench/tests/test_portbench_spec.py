"""The loader finds every file a cell names, and BENCHMARK.json keeps to
the rules of its format."""

import json
import re

import pytest

from portbench import spec
from portbench.loops import Loop
from portbench.tests.conftest import merged_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS + ["bsq8-served", "raw-batch", "bsq8-churn"])
def test_cell_files_and_readers_are_found_by_name(candidates, name):
    cell = spec.cell(name)
    assert cell.config["search"]["topk"] > 0
    assert issubclass(spec.traffic_kind(cell.traffic["kind"]), Loop)
    assert "order_gap" in cell.limits
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]).read)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


@pytest.mark.parametrize("kind", ["no_such_kind"])
def test_unknown_traffic_kind_is_refused(kind):
    with pytest.raises(FileNotFoundError, match="traffic kind"):
        spec.traffic_kind(kind)


def test_a_mix_file_holds_only_the_parameters_of_its_mix():
    # how the harness warms, traces and judges is no mix's to set
    harness = {"warm_calls", "judge_calls", "trace_lead_s", "trace_span_s",
               "drain_s", "warm_cycles", "judge_new_rows"}
    for path in (spec.HERE / "traffic").glob("*.json"):
        mix = spec.load_json(path)
        assert callable(spec.traffic_kind(mix["kind"]))
        assert not harness & set(mix), path.name


@pytest.mark.parametrize("merged", [False, True],
                         ids=["BENCHMARK.json", "with-candidates"])
def test_benchmark_json_keeps_its_format(merged):
    BENCH = merged_benchmark() if merged else spec.benchmark()
    CELLS = [w["name"] for w in BENCH["workloads"]]
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        assert 1 <= len(c["why"]) <= 200 and not set(c["why"]) & set("\n\t")
        assert c["file"].startswith("portbench/")
        assert (spec.ROOT / c["file"]).is_file()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    seen = set()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            reported = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reported, (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
