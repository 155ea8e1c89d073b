"""The RaBitQ hop's counters (``spaces/rabitq.counters``) and the root
span's ``pool`` and ``space``.

On the CPU one search of a small seeded rabitq or rabitq2 index adds to
the counters exactly their closed form in the search's shapes; a bsq8 or
raw hnsw search leaves them as they were, and no graph search moves the
flat scan's (``ops/distance.counters``); the root span
``alaya.engine.batch_search`` records the pool width searched (the boosted
ef of a 1-bit index) and the space's quantization.

With a CUDA device (``python -m pytest --noconftest -m gpu
tests/test_torch_rabitq_counters.py``; no JAX import) one captured replay
adds to every counter what its capture counted, which is what the same
search adds uncaptured.
"""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch import Client, trace
from alayalite_tpu_torch.index import captured
from alayalite_tpu_torch.ops.distance import counters as scan_counters
from alayalite_tpu_torch.spaces.rabitq import counters

torch.set_num_threads(2)

N, DIM, NQ, TOPK, EF = 600, 32, 50, 10, 32


def _index(quant: str, device: str = "cpu", n: int = N, dim: int = DIM):
    x = np.random.default_rng(7).normal(size=(n, dim)).astype(np.float32)
    idx = Client(device=device).create_index(
        f"c{quant}", quantization_type=quant, capacity=n, max_nbrs=32)
    idx.fit(x, ef_construction=64)
    return idx, x


@pytest.fixture(scope="module")
def indices():
    return {}


def _cached(indices, quant):
    if quant not in indices:
        indices[quant] = _index(quant)
    return indices[quant]


def _read() -> dict:
    return {f: getattr(counters, f) for f in counters.FIELDS}


def _added(fn) -> dict:
    before = _read()
    fn()
    return {f: v - before[f] for f, v in _read().items()}


# quant: (pool width searched, hops, code bytes a neighbor: gathered +
# unpacked). 50 queries pad to one 64-row slice; 8 seeds from the sample;
# beam_expand 8; the hop budget max(8, pool // 8 + 4).
CLOSED = {"rabitq": (4 * EF, 20, DIM // 8 + DIM),
          "rabitq2": (EF, 8, 2 * DIM // 8 + DIM)}


@pytest.mark.parametrize("quant", sorted(CLOSED))
def test_counters_follow_the_closed_form(indices, quant):
    """One search adds B·M·32 estimates a hop, their packed bytes and
    unpacked codes, and B·(seeds + M a hop + the pool's rerank) exact
    rows, B the padded rows."""
    idx, x = _cached(indices, quant)
    pool, hops, per_nbr = CLOSED[quant]
    B, M, nseed = 64, 8, 8
    got = _added(lambda: idx.batch_search(x[:NQ], TOPK, ef_search=EF))
    assert got == {"estimated": B * hops * M * 32,
                   "code_bytes": B * hops * M * 32 * per_nbr,
                   "exact_rows": B * (nseed + hops * M + pool)}


@pytest.mark.parametrize("quant", ["bsq8", "none"])
def test_other_spaces_leave_the_counters(indices, quant):
    idx, x = _cached(indices, quant)
    got = _added(lambda: idx.batch_search(x[:NQ], TOPK, ef_search=EF))
    assert got == {f: 0 for f in counters.FIELDS}


@pytest.mark.parametrize("quant", ["rabitq", "bsq8", "none"])
def test_graph_searches_leave_the_scan_counters(indices, quant):
    """The flat scan's counters (``ops/distance.counters``) move only on
    a tiled scan: a graph search leaves them."""
    idx, x = _cached(indices, quant)
    before = {f: getattr(scan_counters, f) for f in scan_counters.FIELDS}
    idx.batch_search(x[:NQ], TOPK, ef_search=EF)
    assert {f: getattr(scan_counters, f)
            for f in scan_counters.FIELDS} == before


@pytest.mark.parametrize("quant,pool", [("rabitq", 4 * EF), ("rabitq2", EF),
                                        ("bsq8", EF), ("none", EF)])
def test_root_span_records_pool_and_space(indices, quant, pool):
    idx, x = _cached(indices, quant)
    trace.enable()
    try:
        trace.clear()
        idx.batch_search(x[:NQ], TOPK, ef_search=EF)
        (root,) = [s for s in trace.spans()
                   if s.name == "alaya.engine.batch_search"]
    finally:
        trace.disable()
        trace.clear()
    # the code row's width: the rotated dim (a power of two here) or
    # bsq8's multiple of 128; a raw index has no code row
    code = {"rabitq": DIM, "rabitq2": DIM, "bsq8": 128}.get(quant)
    assert root.attrs == {"topk": TOPK, "ef": EF, "rows": NQ,
                          "space": quant, "pool": pool, "dim": DIM,
                          **({} if code is None else {"code_dim": code})}


@pytest.mark.gpu
def test_cuda_replay_adds_what_its_capture_counted():
    """A 4,000-row rabitq index on the card: after the capture, one
    replay adds to every counter (kernels and RaBitQ alike) what the same
    search adds uncaptured, and the RaBitQ counters' closed form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    n, dim = 4000, 64
    idx, x = _index("rabitq", "cuda", n, dim)
    eng = idx._engine
    q = torch.as_tensor(x[:NQ], device="cuda")
    eng._batch_search_impl(q, TOPK, EF)                     # captures
    before = captured.counts()
    with captured.eager():
        eng._batch_search_impl(q, TOPK, EF)
    torch.cuda.synchronize()
    mid = captured.counts()
    eng._batch_search_impl(q, TOPK, EF)                     # one replay
    torch.cuda.synchronize()
    after = captured.counts()
    eager = {k: mid[k] - before[k] for k in before}
    replay = {k: after[k] - mid[k] for k in before}
    assert replay == eager
    B, M, hops, pool = 64, 8, 20, 4 * EF
    assert {f: replay[(counters, f, None)] for f in counters.FIELDS} == {
        "estimated": B * hops * M * 32,
        "code_bytes": B * hops * M * 32 * (dim // 8 + dim),
        "exact_rows": B * (8 + hops * M + pool)}
