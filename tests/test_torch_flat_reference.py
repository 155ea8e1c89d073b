"""The flat index's exact scan against the benchmark's plain reference
(``portbench/reference.knn``: a float32 shortlist re-scored in float64),
its counters (``ops/distance.counters``) and its span
(``alaya.flat.scan``).

On the CPU the scan runs ``l2_tile``'s plain version: |q|² + |x|² − 2·q·x
in float32. Its rounding is a few float32 steps of the larger squared norm,
so the distances agree with the reference's float64 ones within
``RTOL`` of |q|² + max |x|² per query, and on these seeded rows no two
neighbours of a query lie that close: the ids are equal, in order.

The engine's scan runs with small tiles and query slices here (``TILE``,
``QCHUNK``), so a few hundred rows cross several tiles, a ragged last tile
and a ragged last slice; one case runs the default 16,384-row tiles.
"""

import functools

import numpy as np
import pytest
import torch

from alayalite_tpu_torch import Client, trace
from alayalite_tpu_torch.index import captured
from alayalite_tpu_torch.index import engine as engine_mod
from alayalite_tpu_torch.ops import distance
from alayalite_tpu_torch.ops.distance import counters
from portbench import reference

torch.set_num_threads(2)

TOPK, TILE, QCHUNK = 10, 128, 32
RTOL = 1e-5


def _flat(n: int, dim: int, seed: int):
    x = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    idx = Client(device="cpu").create_index(f"flat{seed}", index_type="flat",
                                            capacity=n)
    idx.fit(x)
    return idx, x


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setattr(engine_mod, "exact_topk", functools.partial(
        distance.exact_topk, tile_n=TILE, qchunk=QCHUNK))


def _read() -> dict:
    return {f: getattr(counters, f) for f in counters.FIELDS}


def _search(idx, q):
    """(ids, dists, what the counters added)."""
    before = _read()
    ids, d = idx._engine.batch_search_with_distance(q, TOPK)
    return ids, d, {f: v - before[f] for f, v in _read().items()}


def _tiles(n: int, tile: int) -> list:
    return [min(tile, n - lo) for lo in range(0, n, tile)]


def _slices(nq: int, chunk: int) -> list:
    return [min(chunk, nq - lo) for lo in range(0, nq, chunk)]


# case: (rows, dim, queries, removed ids, tile, query slice)
CASES = {
    "tiles": (1000, 16, 20, (), TILE, QCHUNK),            # 7 tiles + 104 rows
    "slices": (700, 16, 70, (), TILE, QCHUNK),            # 32 + 32 + 6 queries
    "removed": (700, 16, 40, tuple(range(130, 200)) + (640, 699), TILE,
                QCHUNK),                                  # tiles 1 and 5 masked
    "default_tiles": (20000, 8, 30, (5, 17000), 16384, 4096),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_exact_matches_the_reference(request, case):
    n, dim, nq, removed, tile, qchunk = CASES[case]
    if tile == TILE:
        request.getfixturevalue("small_tiles")
    idx, x = _flat(n, dim, seed=sorted(CASES).index(case) + 11)
    if removed:
        idx.remove(list(removed))
    q = np.random.default_rng(99).normal(size=(nq, dim)).astype(np.float32)
    ids, d, added = _search(idx, q)

    live = np.setdiff1d(np.arange(n), removed)
    ref = reference.knn(torch.as_tensor(x[live]), torch.as_tensor(q), TOPK)
    np.testing.assert_array_equal(ids, live[ref.ids.numpy()])
    scale = (q.astype(np.float64) ** 2).sum(1) + (
        x[live].astype(np.float64) ** 2).sum(1).max()
    err = np.abs(d - ref.dists.numpy())
    np.testing.assert_array_less(err, np.broadcast_to(RTOL * scale[:, None],
                                                      err.shape))

    tiles, slices = _tiles(n, tile), _slices(nq, qchunk)
    assert added == {
        "pairs": nq * n,
        "tiles": len(slices) * len(tiles),
        "candidates": nq * sum(min(TOPK, t) for t in tiles)}


def test_scan_span_records_its_attributes(small_tiles):
    n, nq = 700, 70
    idx, x = _flat(n, 16, seed=3)
    trace.enable()
    try:
        trace.clear()
        idx.batch_search(x[:nq], TOPK)
        (scan,) = [s for s in trace.spans() if s.name == "alaya.flat.scan"]
        (root,) = [s for s in trace.spans()
                   if s.name == "alaya.engine.batch_search"]
    finally:
        trace.disable()
        trace.clear()
    assert scan.attrs == {"mode": "exact", "rows": n, "queries": nq,
                          "tiles": 3 * 6}
    assert scan.parent == root.id


def test_counts_carry_the_scan_counters_under_fixed_keys():
    idx, x = _flat(300, 8, seed=5)
    before = captured.counts()
    idx.batch_search(x[:7], TOPK)
    after = captured.counts()
    assert after.keys() == before.keys()
    assert {f: after[(counters, f, None)] - before[(counters, f, None)]
            for f in counters.FIELDS} == {"pairs": 7 * 300, "tiles": 1,
                                          "candidates": 7 * TOPK}
