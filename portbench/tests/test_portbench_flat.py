"""The ``flat-exact`` cell on the CPU at its configuration's rehearsal
sizes (20,000 rows: a full tile of 16,384 and a ragged one): a sound run is
correct; the control (the reference in TF32) is not, by ``order_gap``; a
scan that skips the last full tile of each query slice is not, by
``recall10``. Its two readers on synthetic runs read their hand-counted
values, and nothing where the counts disagree."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from alayalite_tpu_torch import Client
from alayalite_tpu_torch.ops import distance
from portbench import roofline, spec, trace
from portbench import run as runmod

CELL = "flat-exact"


def _run(capsys, *extra, seed=3100000019):
    rc = runmod.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                      "2", "--trace", "0", "--rehearse", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _skip_last_full_tile(monkeypatch):
    """The planted fault: each slice's scan masks its last full tile of
    rows (on SIFT1M's 1M rows 16,384 of them, 1.6%; here the first)."""
    orig = distance._exact_topk_device

    def skip(q, x, x_sq, valid, k, metric, tile_n, bf16):
        n = x.shape[0]
        lo = (n // tile_n - 1) * tile_n
        v = (torch.ones(n, dtype=torch.bool, device=x.device)
             if valid is None else valid[:n].clone())
        v[lo:lo + tile_n] = False
        return orig(q, x, x_sq, v, k, metric, tile_n, bf16)

    monkeypatch.setattr(distance, "_exact_topk_device", skip)


@pytest.mark.parametrize("case", ["sound", "control", "skip_tile"])
def test_rehearsal(capsys, monkeypatch, case):
    if case == "skip_tile":
        _skip_last_full_tile(monkeypatch)
    res = _run(capsys, *(["--control"] if case == "control" else []))
    cmp = res["compared"]
    if case == "sound":
        assert res["correct"] is True, cmp
        assert res["device"]["platform"] == "cpu"
        assert {"setup_s", "qps", "recall10"} <= set(res["metrics"])
        assert cmp["bad_answers"]["value"] == 0
        assert cmp["recall10"]["value"] == 1.0
        return
    assert res["correct"] is False, cmp
    if case == "control":
        assert cmp["order_gap"]["value"] > 2e-4
    else:
        assert cmp["recall10"]["value"] < float(
            cmp["recall10"]["limit"].split()[-1])


# ---------------------------------------------------------------- readers
def _counted(before: dict, after: dict):
    return ({"by_kernel": before, "launches": sum(before.values())},
            {"by_kernel": after, "launches": sum(after.values())})


def _ev(name, start, end, dev=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


TILE = "void (anonymous namespace)::l2_tile_kernel<true>(float const*)"
TOPK = "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>"
MERGE = "void (anonymous namespace)::merge_kv_kernel<10>(float const*)"
H2D = "Memcpy HtoD (Pageable -> Device)"
D2H = "Memcpy DtoH (Device -> Pageable)"
# a call: a full tile (4,096 queries) and a ragged one (1,808) over 16,384
# rows of 128 dimensions
SHAPES = [(4096, 16384, 128), (1808, 16384, 128)]
PAIRS = 4096 * 16384 + 1808 * 16384


def _trace(tiles: int, calls: int = 2):
    """``calls`` calls traced, with ``tiles`` tile launches of 500 µs in
    all; a top k of 300 µs and a merge of 20 µs after each tile; one copy
    in and one out of 40 µs a call."""
    events = [_ev(trace.MARK, 0, 100_000, DeviceType.CPU)]
    t = 100
    for j in range(tiles):
        if j % 2 == 0:
            events.append(_ev(H2D, t, t + 40))
            t += 50
        events += [_ev(TILE, t, t + 500), _ev(TOPK, t + 500, t + 800),
                   _ev(MERGE, t + 800, t + 820)]
        t += 1000
        if j % 2 == 1:
            events.append(_ev(D2H, t, t + 40))
            t += 50
    return trace.reduce_events(events, {"calls": calls,
                                        "queries": calls * 5904})


def _run_of(tiles=4, window=20, calls=10, probe=None):
    before, after = _counted({"l2_tile": 3, "merge_kv": 3},
                             {"l2_tile": 3 + window, "merge_kv": 3 + window})
    probes = {} if probe is None else {"l2_tile": probe}
    return SimpleNamespace(
        trace_result=_trace(tiles), window={"calls": calls, "answered":
                                            calls * 5904},
        before=before, after=after, info={}, probes=probes)


SOUND_PROBE = {"shapes": SHAPES, "pairs": PAIRS, "launched": 2}
BOUND_S = (roofline.bound_s(4 * (4096 * 128 + 16384 * 128 + 4096 * 16384),
                            2 * 4096 * 16384 * 128)
           + roofline.bound_s(4 * (1808 * 128 + 16384 * 128 + 1808 * 16384),
                              2 * 1808 * 16384 * 128))


@pytest.mark.parametrize("tiles,window,probe,want", [
    # both launches bound by operations: 0.25642 ms and 0.11318 ms a call,
    # against 4 launches of 0.5 ms
    (4, 20, SOUND_PROBE, 100 * 2 * BOUND_S / 2e-3),
    (4, 22, SOUND_PROBE, None),        # the probe's count is not the window's
    (4, 20, dict(SOUND_PROBE, pairs=PAIRS - 1), None),   # pairs disagree
    (4, 20, dict(SOUND_PROBE, launched=0), None),        # no launch (CPU)
    (5, 20, SOUND_PROBE, None),        # more traced than the calls made
    (0, 20, SOUND_PROBE, None),        # none traced
    (4, 20, None, None)])              # no counter: the parent
def test_l2_tile_roofline_reader(tiles, window, probe, want):
    got = spec.reader("l2_tile_roofline").read(_run_of(tiles, window,
                                                       probe=probe))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-9)
        assert 0 < got <= 100


@pytest.mark.parametrize("tiles,window,want", [
    # 4 top k of 300 µs and 4 merges of 20 µs over 2 calls of 5,904
    # queries; the tiles and the copies left out
    (4, 20, 4 * 320e-6 * 1e3 / (2 * 5.904)),
    (4, 21, None),                     # launches not a whole number a call
    (3, 20, None),                     # the trace cut a call
    (0, 0, None)])                     # no scan in the window
def test_select_reader(tiles, window, want):
    got = spec.reader("flat.select_ms_per_kq").read(_run_of(tiles, window))
    assert got == (pytest.approx(want, rel=1e-9) if want is not None
                   else None)


def test_roofline_probe_records_the_scan():
    """On the CPU the probe records one search's tile shapes and the
    ``pairs`` it scored; no kernel launched, so the reader reads nothing."""
    x = np.random.default_rng(1).normal(size=(20000, 16)).astype(np.float32)
    idx = Client(device="cpu").create_index("f", index_type="flat",
                                            capacity=20000)
    idx.fit(x)
    q = torch.as_tensor(x[:30])
    run = SimpleNamespace(
        trace_result=_trace(4), window={"calls": 10}, probes={}, info={},
        idx=idx, device=torch.device("cpu"),
        loop=SimpleNamespace(data=SimpleNamespace(queries=q), k=10, ef=10))
    reader = spec.reader("l2_tile_roofline")
    reader.probe(run)
    assert run.probes["l2_tile"] == {
        "shapes": [(30, 16384, 16), (30, 3616, 16)], "pairs": 30 * 20000,
        "launched": 0}
    run.before, run.after = _counted({"l2_tile": 0}, {"l2_tile": 0})
    assert reader.read(run) is None
