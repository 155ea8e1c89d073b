import numpy as np
import pytest
import torch

from portbench import judge, reference


@pytest.fixture(scope="module")
def case():
    g = np.random.default_rng(5)
    c = g.normal(size=(6, 32)) * 4
    x = (c[g.integers(0, 6, 2000)] + g.normal(size=(2000, 32))
         ).astype(np.float32)
    q = (x[g.integers(0, 2000, 100)] + 0.25 * g.normal(size=(100, 32))
         ).astype(np.float32)
    xt, qt = torch.as_tensor(x), torch.as_tensor(q)
    ref = reference.knn(xt, qt, 10)
    pos = torch.arange(2000)
    return xt, qt, ref, pos


def _numbers(case, ids):
    xt, qt, ref, pos = case
    return judge.answer_numbers(ids, np.arange(ids.shape[0]), qt, ref, pos,
                                xt, 10)


def test_exact_answers_read_clean(case):
    ids = case[2].ids.numpy()
    r = _numbers(case, ids)
    assert r == {"bad_answers": 0.0, "recall10": 1.0, "order_gap": 0.0,
                 "bad_kinds": {"missing": 0, "not_live": 0, "repeated": 0}}


def test_an_altered_answer_steps_back(case):
    ids = case[2].ids.numpy().copy()
    ids[3] = np.roll(ids[3], 1)            # the nearest moved to the end
    r = _numbers(case, ids)
    assert r["order_gap"] > 0.1 and r["bad_answers"] == 0


def test_missing_deleted_and_repeated_ids_are_bad(case):
    xt, qt, ref, pos = case
    ids = ref.ids.numpy().copy()
    ids[0] = -1                              # half of a batch left out
    ids[1, 4] = ids[1, 3]                    # one id twice
    ids[2, 9] = 5000                         # out of range
    dead = pos.clone()
    gone = int(ids[4, 0])
    dead[gone] = -1                          # a removed row returned
    r = judge.answer_numbers(ids, np.arange(100), qt, ref, dead, xt, 10)
    rows = {0, 1, 2} | set(np.flatnonzero((ids == gone).any(1)).tolist())
    assert r["bad_answers"] == float(len(rows)) >= 4
    assert r["bad_kinds"] == {"missing": 1, "not_live": len(rows) - 2,
                              "repeated": 1}
    assert r["recall10"] < 1.0


def test_compared_limits_and_lines():
    nums = {"bad_answers": 0.0, "recall10": 0.99, "order_gap": 1e-3}
    out = judge.compared(nums, {"order_gap": {"limit": 2e-4}}, 0.95)
    ok = {c.name: c.ok for c in out}
    assert ok == {"bad_answers": True, "recall10": True, "order_gap": False}
    assert "limit <= 0.0002" in out[2].line()
    assert out[0].entry() == {"value": 0.0, "limit": "<= 0.0"}
    nan = judge.Compared("x", float("nan"), 1.0, "<=")
    assert not nan.ok


@pytest.mark.parametrize("limits,floor,recall,ok", [
    ({"recall10": {"limit": 0.98}}, 0.95, 0.975, False),
    ({"recall10": {"limit": 0.98}}, 0.95, 0.985, True),
    ({"recall10": {"limit": 0.90}}, 0.95, 0.94, False),   # the floor holds
    ({}, 0.95, 0.96, True)])
def test_recall_limit_from_readings_never_under_the_floor(limits, floor,
                                                          recall, ok):
    nums = {"bad_answers": 0.0, "recall10": recall, "order_gap": 0.0}
    out = judge.compared(nums, {"order_gap": {"limit": 2e-4}, **limits},
                         floor)
    assert {c.name: c.ok for c in out}["recall10"] is ok


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_exact_answers_read_clean_under_the_metric(case, metric):
    xt, qt, _, pos = case
    ref = reference.knn(xt, qt, 10, metric)
    ids = ref.ids.numpy()
    r = judge.answer_numbers(ids, np.arange(100), qt, ref, pos, xt, 10,
                             metric)
    assert r["recall10"] == 1.0 and r["order_gap"] == 0.0
    ids = ids.copy()
    ids[7] = ids[7][::-1]
    r = judge.answer_numbers(ids, np.arange(100), qt, ref, pos, xt, 10,
                             metric)
    assert r["order_gap"] > 0.0


def test_check_inserted_ids():
    steps = [np.array([10, 11, 12]), np.array([13, 11, -1, 3, 99])]
    # 11 repeated, -1 and 3 below the first new id, 99 past capacity
    assert judge.check_inserted(steps, first_new=10, capacity=50) == 4
    assert judge.check_inserted([], 10, 50) == 0


def test_new_top1():
    ids = np.array([[5, 1], [7, 6], [2, 9]])
    assert judge.new_top1(ids, np.array([5, 6, 2])) == pytest.approx(2 / 3)
    assert judge.new_top1(ids[:0], np.array([], dtype=int)) is None
