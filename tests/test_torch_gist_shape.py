"""bsq8 hnsw at GIST1M's width (D 960, the configuration
``portbench/configs/gist960-hnsw-bsq8.json``) on the CPU, against the
benchmark's plain reference (``portbench/reference.knn``: a float32
shortlist re-scored in float64, plain torch, no JAX).

The rows are the benchmark's stand-in mixture at a small n, fitted with
the configuration's own index parameters but a seed sample of 256 rows
(the configuration's 16,384 would hold every row here, and the seed scan
alone would find most answers): the graph's 960-wide hops do the work,
as at 1M rows on the card, where the sample holds 1.6% of the rows.
1,000 held-out queries go through ``Index.batch_search`` as one
1,024-row slice (``qchunk`` 1,024 at D ≥ 512), as on the card. The code
rows are 1,024 bytes (960 rounded up to 128's multiple with the centre
byte), so each popped node's block is 32 KB and
``gather_estimate.code_bytes`` grows by B·M·R·Dp = 1,024 · 8 · 32 · 1,024
a hop.

The returned distances are the exact re-score's float32 |q|² + |x|² −
2·q·x (``gather_dot``'s plain version): each of its three sums of 960
products is off by at most ~960 float32 steps of its size (γ_D ≈ D·2⁻²⁴,
the bound of a sequential sum), so the distance is within
``D · 2⁻²⁴ · (|q|² + |x|²)`` of the float64 distance of the same ids.
"""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch import Client, trace
from alayalite_tpu_torch.index import captured
from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
from alayalite_tpu_torch.spaces import bqg
from portbench import data as data_mod
from portbench import judge, reference, spec

torch.set_num_threads(2)

CONFIG = spec.load_json(spec.HERE / "configs" / "gist960-hnsw-bsq8.json")
N, SEED, ALONE, SAMPLE = 1500, 2700002727, 200, 256
DIM = CONFIG["data"]["dim"]
NQ = CONFIG["data"]["n_queries"]
K, EF = CONFIG["search"]["topk"], CONFIG["search"]["ef"]
FLOOR = CONFIG["search"]["recall_floor"]


@pytest.fixture(scope="module")
def gist():
    """The fitted index, its data, the 1,000-query call's answers, the
    shapes of that call's ``gather_estimate`` calls, its change in
    ``code_bytes`` and its spans."""
    sizes = dict(CONFIG["data"], n=N, clusters=8)
    data = data_mod.make(sizes, SEED, torch.device("cpu"))
    params = dict(CONFIG["index"], capacity=N, seed_sample=SAMPLE)
    idx = Client(device="cpu").create_index("gist", **params)
    idx.fit(data.base, ef_construction=CONFIG["fit"]["ef_construction"])
    q = data.queries.numpy()
    idx.batch_search(q[:8], K, ef_search=EF)       # draws the seed sample
    shapes = []
    orig = bqg.gather_estimate

    def recorded(codes, u, *args, **kwargs):
        shapes.append((*u.shape, *codes.shape[1:]))
        return orig(codes, u, *args, **kwargs)

    bqg.gather_estimate = recorded
    trace.enable()
    try:
        trace.clear()
        before = gather_estimate.code_bytes
        ids, dists = idx.batch_search_with_distance(q, K, ef_search=EF)
        code_bytes = gather_estimate.code_bytes - before
        spans = trace.spans()
    finally:
        bqg.gather_estimate = orig
        trace.disable()
        trace.clear()
    return dict(idx=idx, data=data, ids=ids, dists=dists, shapes=shapes,
                code_bytes=code_bytes, spans=spans)


def test_answers_against_the_reference(gist):
    data = gist["data"]
    ref = reference.knn(data.base, data.queries, K, "l2")
    got = judge.answer_numbers(gist["ids"], np.arange(NQ), data.queries, ref,
                               torch.arange(N), data.base, K)
    assert gist["ids"].shape == (NQ, K)
    assert got["bad_answers"] == 0, got["bad_kinds"]
    assert got["recall10"] >= FLOOR


def test_distances_are_the_float64_distances_of_their_ids(gist):
    data, ids = gist["data"], torch.as_tensor(gist["ids"].astype(np.int64))
    assert (ids >= 0).all()
    q, x = data.queries.double(), data.base.double()
    want = reference.exact_f64(data.queries, data.base[ids], "l2")
    scale = (q * q).sum(1, keepdim=True) + (x * x).sum(1)[ids]
    err = (torch.as_tensor(gist["dists"]).double() - want).abs()
    assert (err <= DIM * 2.0 ** -24 * scale).all(), float((err / scale).max())


def test_reference_shortlist_is_the_full_float64_top10():
    """At D 960 the reference's float32 shortlist holds the exact top 10:
    its ids equal a float64 top 10 over every row."""
    data = data_mod.make(dict(CONFIG["data"], n=N, clusters=8), SEED + 1,
                         torch.device("cpu"))
    ref = reference.knn(data.base, data.queries, K, "l2")
    full = torch.cdist(data.queries.double(), data.base.double()) ** 2
    want_d, want_i = torch.topk(full, K, dim=1, largest=False)
    assert torch.equal(ref.ids, want_i)
    torch.testing.assert_close(ref.dists, want_d, rtol=1e-12, atol=0.0)


def test_a_query_answers_alike_alone_and_in_the_slice(gist):
    """The first 200 queries searched alone (a 256-row slice) return the
    same ids and the same distance bits as inside the 1,000-query call."""
    q = gist["data"].queries.numpy()[:ALONE]
    ids, dists = gist["idx"].batch_search_with_distance(q, K, ef_search=EF)
    np.testing.assert_array_equal(ids, gist["ids"][:ALONE])
    np.testing.assert_array_equal(dists.view(np.int32),
                                  gist["dists"][:ALONE].view(np.int32))


def test_code_bytes_count_every_pair_of_a_call(gist):
    """One 1,024-row slice: every hop's ``gather_estimate`` at (1,024, 8,
    32, 1,024), and the counter's change is Σ B·M·R·Dp over them."""
    shapes = gist["shapes"]
    assert shapes and set(shapes) == {(1024, 8, 32, 1024)}
    assert gist["code_bytes"] == sum(B * M * R * Dp
                                     for B, M, R, Dp in shapes)
    assert (gather_estimate, "code_bytes", None) in captured.counts()


def test_counts_hold_code_bytes_under_fixed_keys():
    """``captured.counts()`` has the counter's key in its first snapshot
    and the same keys in every later one (tests subtract snapshots key by
    key)."""
    before = captured.counts()
    x = np.random.default_rng(5).normal(size=(300, 16)).astype(np.float32)
    idx = Client(device="cpu").create_index(
        "g", quantization_type="bsq8", capacity=300, max_nbrs=16)
    idx.fit(x)
    idx.batch_search(x[:20], K, ef_search=32)
    after = captured.counts()
    assert (gather_estimate, "code_bytes", None) in before
    assert after.keys() == before.keys()
    assert after[(gather_estimate, "code_bytes", None)] > before[
        (gather_estimate, "code_bytes", None)]


def test_spans_record_the_slice_and_the_widths(gist):
    spans = gist["spans"]
    (root,) = [s for s in spans if s.name == "alaya.engine.batch_search"]
    (pad,) = [s for s in spans if s.name == "alaya.search.pad"]
    assert root.attrs["dim"] == DIM and root.attrs["code_dim"] == 1024
    assert pad.attrs == {"rows": 1024, "slice_rows": 1024, "slices": 1}
    assert pad.parent == root.id
