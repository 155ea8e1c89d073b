"""The ``gist-bsq8-batch`` cell on the CPU at its configuration's rehearsal
sizes (2,000 rows of 960 dimensions, the 1,000 queries: one 1,024-row
slice): a sound run is correct; the control (the reference in TF32) is
not. Its two readers, ``gather_estimate_roofline`` and
``search.code_kb_per_q``, on synthetic runs and a small bsq8 index read
their hand-counted values, and nothing where the counts disagree.

The search planted at half its ef (48) reads lower recall than the sound
search here, but not under the cell's limit: every rehearsal row lies in
the 16,384-row seed sample, so the seed scan alone finds most of each
query's neighbours. The rehearsal (``run.rehearsal``) takes only the data
sizes from the configuration, so the sample stays 16,384 rows; at 2,000
rows a 256-row sample does not help either (ef 48 reads 0.999). The limit
is set from the card's readings at 1M rows, where the sample holds 1.6% of
them (PERF.md section 2); ``tests/test_torch_gist_shape.py`` fits with a
256-row sample, where a wrong 960-wide hop fails its recall floor."""

import contextlib
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from alayalite_tpu_torch import Client
from alayalite_tpu_torch.index.engine import IndexEngine
from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
from alayalite_tpu_torch.spaces import bqg
from portbench import roofline, spec, trace
from portbench import run as runmod

CELL = "gist-bsq8-batch"


def _run(*extra, seed=3100000019):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runmod.main(["--workload", CELL, "--seed", str(seed),
                          "--seconds", "2", "--trace", "0", "--rehearse",
                          *extra])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_sound_rehearsal_is_correct(sound):
    cmp = sound["compared"]
    assert sound["correct"] is True, cmp
    assert sound["device"]["platform"] == "cpu"
    assert {"setup_s", "qps", "recall10"} <= set(sound["metrics"])
    assert cmp["bad_answers"]["value"] == 0


def test_control_is_not_correct():
    res = _run("--control")
    assert res["correct"] is False, res["compared"]
    assert res["compared"]["order_gap"]["value"] > 2e-4


def test_search_at_half_its_ef_reads_lower_recall(monkeypatch, sound):
    """The search at half its ef (48, with that ef's default hop budget)."""
    orig = IndexEngine._batch_search_impl

    def half(self, queries, topk, ef=100, *a, **k):
        return orig(self, queries, topk, max(int(topk), int(ef) // 2), *a,
                    **k)

    monkeypatch.setattr(IndexEngine, "_batch_search_impl", half)
    cmp = _run()["compared"]
    assert cmp["bad_answers"]["value"] == 0
    assert cmp["recall10"]["value"] < sound["compared"]["recall10"]["value"]


# ---------------------------------------------------------------- readers
def _counted(before: dict, after: dict):
    return ({"by_kernel": before, "launches": sum(before.values())},
            {"by_kernel": after, "launches": sum(after.values())})


def _ev(name, start, end, dev=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


EST = ("void (anonymous namespace)::gather_rows_kernel<4, true>(unsigned "
       "char const*, int const*)")
DOT = ("void (anonymous namespace)::gather_rows_kernel<4, false>(unsigned "
       "char const*, int const*)")
# one search's two launches over codes [8, 2, 16]: u [[3, 3, -1], [5, 3, 0]]
# (nodes 0, 3, 5: node 3 popped three times, -1 not a node) and u [[1]]
U = [[[3, 3, -1], [5, 3, 0]], [[1]]]
# by hand: 3 nodes x 2 x (16 + 8) + 2 x (2 x 16 + 4) + 2 x 3 x 4
# + 2 x 3 x 2 x 8, and 1 x 2 x 24 + 1 x 36 + 1 x 4 + 1 x 2 x 8
BYTES = [144 + 72 + 24 + 96, 48 + 36 + 4 + 16]


def test_roofline_bytes_by_hand():
    f = spec.reader("gather_estimate_roofline").gather_estimate_bytes
    assert [f(2, 3, 2, 16, 3), f(1, 1, 2, 16, 1)] == BYTES


def _probed(monkeypatch, card_launches=True):
    """The reader's probe over a stand-in engine whose search makes the two
    ``gather_estimate`` calls of ``U`` on the CPU; ``card_launches`` counts
    a launch for each, as the card would."""
    monkeypatch.setattr(gather_estimate, "launches", gather_estimate.launches)
    C, R, Dp = 8, 2, 16
    g = torch.Generator().manual_seed(3)
    codes = torch.randint(0, 256, (C, R, Dp), generator=g,
                          dtype=torch.uint8)
    xsq = torch.rand((C, R), generator=g)
    nbr = torch.randint(-1, C, (C, R), generator=g, dtype=torch.int32)

    def search(q, k, ef, _capture=True):
        for u in U:
            u = torch.tensor(u, dtype=torch.int32)
            B = u.shape[0]
            qs = torch.ones((B, Dp), dtype=torch.bfloat16)
            bqg.gather_estimate(codes, u, qs, torch.zeros(B), 1.0, xsq, nbr,
                                True)
            gather_estimate.launches += int(card_launches)

    run = SimpleNamespace(
        trace_result=_trace(4), window={"calls": 10}, probes={}, info={},
        idx=SimpleNamespace(_engine=SimpleNamespace(
            _batch_search_impl=search)),
        device=torch.device("cpu"),
        loop=SimpleNamespace(data=SimpleNamespace(queries=None), k=10,
                             ef=64))
    spec.reader("gather_estimate_roofline").probe(run)
    return run


def _trace(launches: int, calls: int = 2):
    """``calls`` calls traced, with ``launches`` estimate launches of 100
    µs and as many plain dots (``gather_diagdot``) beside them."""
    events = [_ev(trace.MARK, 0, 100_000, DeviceType.CPU)]
    for j in range(launches):
        events += [_ev(EST, 200 * j, 200 * j + 100),
                   _ev(DOT, 200 * j + 100, 200 * j + 150)]
    return trace.reduce_events(events, {"calls": calls,
                                        "queries": calls * 1000})


def test_roofline_probe_counts_each_distinct_node_once(monkeypatch):
    run = _probed(monkeypatch)
    assert run.probes["gather_estimate"] == {
        "shapes": [(2, 3, 2, 16, 3), (1, 1, 2, 16, 1)], "launched": 2,
        "code_bytes": 2 * 3 * 2 * 16 + 1 * 1 * 2 * 16}


@pytest.mark.parametrize("launches,window,card,want", [
    # 4 launches traced over 2 calls, each call's two launches at BYTES
    (4, 20, True, 100 * roofline.bound_s(2 * sum(BYTES)) / 400e-6),
    (4, 22, True, None),      # the probe's count is not the window's
    (4, 20, False, None),     # the probe launched nothing (the CPU)
    (5, 20, True, None),      # more traced than the calls made
    (0, 20, True, None)])     # none traced
def test_roofline_reader(monkeypatch, launches, window, card, want):
    run = _probed(monkeypatch, card)
    run.trace_result = _trace(launches)
    run.before, run.after = _counted({"gather_estimate": 7},
                                     {"gather_estimate": 7 + window})
    got = spec.reader("gather_estimate_roofline").read(run)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-9)
        assert 0 < got <= 100


@pytest.fixture(scope="module")
def small_bsq8():
    x = np.random.default_rng(11).normal(size=(600, 32)).astype(np.float32)
    idx = Client(device="cpu").create_index(
        "k", quantization_type="bsq8", capacity=600, max_nbrs=16)
    idx.fit(x)
    return idx, x


def _code_kb_run(idx, q, window_launches=0):
    """A traced run over ``idx`` whose window made 10 calls of the queries
    ``q`` and ``window_launches`` estimate launches a call; the probe is
    ``gather_estimate_roofline``'s."""
    before, after = _counted({"gather_estimate": 5},
                             {"gather_estimate": 5 + 10 * window_launches})
    run = SimpleNamespace(
        trace_result=_trace(4), window={"calls": 10, "answered": 10 * len(q)},
        before=before, after=after, info={}, probes={}, idx=idx,
        device=torch.device("cpu"),
        loop=SimpleNamespace(data=SimpleNamespace(queries=q), k=10, ef=32))
    spec.reader("gather_estimate_roofline").probe(run)
    return run


def test_code_kb_per_q_is_the_pairs_bytes_a_query(small_bsq8):
    """Σ B·M·R·Dp of the probe call's ``gather_estimate`` calls (B the
    64-row bucket of 50 queries, Dp 128 for 32 dimensions) over its 50
    queries, in KiB; the CPU launches nothing, as the window did not."""
    idx, x = small_bsq8
    run = _code_kb_run(idx, x[:50])
    shapes = run.probes["gather_estimate"]["shapes"]
    assert shapes and {s[:1] + s[2:4] for s in shapes} == {(64, 16, 128)}
    want = sum(B * M * R * Dp for B, M, R, Dp, _ in shapes) / 50 / 1024
    got = spec.reader("search.code_kb_per_q").read(run)
    assert got == pytest.approx(want, rel=1e-12)


def test_code_kb_per_q_reads_nothing_where_counts_disagree(small_bsq8):
    idx, x = small_bsq8
    reader = spec.reader("search.code_kb_per_q")
    run = _code_kb_run(idx, x[:50], window_launches=2)
    assert reader.read(run) is None          # the window launched, the probe not
    run = _code_kb_run(idx, x[:50])
    run.probes["gather_estimate"]["code_bytes"] = None
    assert reader.read(run) is None          # a program without the counter
    del run.probes["gather_estimate"]
    assert reader.read(run) is None          # the probe did not run
