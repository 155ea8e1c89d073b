"""The ``rabitq-batch`` cell on the CPU at its configuration's rehearsal
sizes: a sound run is correct; the control (the reference in TF32) and the
search at half its ef are not. Its two readers on synthetic runs read
their hand-counted values, and nothing where the counts disagree."""

import json
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from alayalite_tpu_torch.index.engine import IndexEngine
from portbench import run as runmod
from portbench import spec, trace

CELL = "rabitq-batch"


def _run(capsys, *extra, seed=3100000019):
    rc = runmod.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                      "2", "--trace", "0", "--rehearse", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _half_ef(monkeypatch):
    """The search at half its ef with that ef's hop budget: the frontier's
    point below (ef 48, max(3, ef // 8) = 6 hops)."""
    orig = IndexEngine._batch_search_impl

    def half(self, queries, topk, ef=100, *a, **k):
        ef = max(int(topk), int(ef) // 2)
        monkeypatch.setattr(self.params, "search_iters", max(3, ef // 8))
        return orig(self, queries, topk, ef, *a, **k)

    monkeypatch.setattr(IndexEngine, "_batch_search_impl", half)


@pytest.mark.parametrize("case", ["sound", "control", "half_ef"])
def test_rehearsal(capsys, monkeypatch, case):
    if case == "half_ef":
        _half_ef(monkeypatch)
    res = _run(capsys, *(["--control"] if case == "control" else []))
    if case == "sound":
        assert res["correct"] is True, res["compared"]
        assert res["device"]["platform"] == "cpu"
        assert {"setup_s", "qps", "recall10"} <= set(res["metrics"])
        return
    assert res["correct"] is False, res["compared"]
    if case == "control":
        assert res["compared"]["order_gap"]["value"] > 2e-4
    else:
        rec = res["compared"]["recall10"]
        assert rec["value"] < float(rec["limit"].split()[-1])


# ---------------------------------------------------------------- readers
def _counted(before: dict, after: dict):
    return ({"by_kernel": before, "launches": sum(before.values())},
            {"by_kernel": after, "launches": sum(after.values())})


def _exact_rows_run(window_launches: int, probe_launches: int):
    """Ten calls of 2,000 queries each; the probe's call read 1,200 rows
    and launched ``probe_launches`` dots."""
    before, after = _counted({"block_diagdot": 5}, {
        "block_diagdot": 5 + window_launches})
    return SimpleNamespace(
        window={"calls": 10, "answered": 20_000}, before=before,
        after=after, info={},
        probes={"rabitq.exact_rows": {"exact_rows": 1_200_000,
                                      "block_diagdot": probe_launches}})


@pytest.mark.parametrize("window,probe,want", [
    (120, 12, 600.0),                  # 1,200,000 rows a call, 2,000 queries
    (130, 12, None),                   # another search ran in the window
    (0, 0, 600.0)])                    # a CPU run: no launches
def test_exact_rows_reader(window, probe, want):
    got = spec.reader("rabitq.exact_rows_per_q").read(
        _exact_rows_run(window, probe))
    assert got == (pytest.approx(want) if want is not None else None)


def test_exact_rows_reader_reads_nothing_without_the_counter():
    run = _exact_rows_run(120, 12)
    run.probes = {}
    assert spec.reader("rabitq.exact_rows_per_q").read(run) is None


ROWS = "void (anonymous namespace)::gather_rows_kernel<1, {}>(unsigned char const*)"


def _ev(name, start, end, dev=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


def _roofline_run(dots: int, gather_diagdot: int = 0, traced: int = 4):
    """Two calls traced, two dots a call of (4096, 256, 128), each traced
    dot 55.6 µs; a fused estimate (``true``) beside them is not counted."""
    events = [_ev(trace.MARK, 0, 10_000, DeviceType.CPU)]
    for j in range(traced):
        events.append(_ev(ROWS.format("false"), 100 + 1000 * j,
                          155.6 + 1000 * j))
    events.append(_ev(ROWS.format("true"), 6000, 6100))
    tr = trace.reduce_events(events, {"calls": 2, "queries": 20_000})
    before, after = _counted(
        {"block_diagdot": 0, "gather_diagdot": 0},
        {"block_diagdot": dots, "gather_diagdot": gather_diagdot})
    return SimpleNamespace(
        trace_result=tr, window={"calls": 10}, before=before, after=after,
        info={}, probes={"block_diagdot": [(4096, 256, 128)] * 2})


@pytest.mark.parametrize("dots,gd,traced,want", [
    # bytes a launch: 134,217,728 codes + 1,048,576 qs + 4,194,304 dots
    (20, 0, 4, 100 * 139_460_608 / 3.35e12 / 55.6e-6),
    (22, 0, 4, None),                  # the probe's count is not the window's
    (20, 3, 4, None),                  # gather_diagdot shares the name
    (20, 0, 5, None),                  # more traced than the calls made
    (20, 0, 0, None)])                 # none traced
def test_block_diagdot_roofline_reader(dots, gd, traced, want):
    got = spec.reader("block_diagdot_roofline").read(
        _roofline_run(dots, gd, traced))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-9)
        assert 0 < got <= 100
