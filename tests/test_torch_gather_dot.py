"""gather_dot, the exact re-scoring: f32 rows read by id and their clamped
L2 distances (or dots) to the queries in one kernel.

On the CPU: the plain version ``gather_dot_ref`` against each f32 space's
``gather_dists`` formula and ``exact_rescore``'s as they stood before the
kernel (``index_select``, ``row_dots``, the PyTorch epilogue), bit for bit;
the sharded slab's ``gather_dists`` and the flat search's f32 rerank
against their former formulas too; the clamp of out-of-range ids; int32
and int64 ids; the wrapper's checks and counters, and ``captured.counts()``
carrying them.

With a CUDA device (``python -m pytest --noconftest -m gpu
tests/test_torch_gather_dot.py``; no JAX import): the kernel against a
float64 reference at the paths' shapes and at odd ones (D 96, 960, 100,
98, 1536; the 16-byte and the word-by-word loads), the bits of the plain
version at D = 128, one (query, row) pair bit-equal whatever the batch,
K, the ids' type and the loads, a captured replay, and the spaces'
``gather_dists``, ``exact_rescore``, the sharded slab and the flat
rerank launching it (f32 rows) or not (bf16 rows)."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.index import captured
from alayalite_tpu_torch.index.search import exact_rescore
from alayalite_tpu_torch.ops.distance import row_dots, sqnorms
from alayalite_tpu_torch.ops.gather_dot import gather_dot, gather_dot_ref
from alayalite_tpu_torch.spaces.bqg import BQGSpace
from alayalite_tpu_torch.spaces.rabitq import RaBitQSpace, counters
from alayalite_tpu_torch.spaces.raw import RawSpace


def _inputs(rng, B, K, D, C, dev="cpu", ids_dtype=torch.int32):
    """(data [C, D], ids [B, K] with -1 and past-C entries, q [B, D])."""
    data = torch.from_numpy(rng.normal(size=(C, D)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    ids = rng.integers(0, C, size=(B, K))
    ids[rng.random((B, K)) < 0.05] = -1
    ids[rng.random((B, K)) < 0.02] = C + 3
    return (data.to(dev), torch.from_numpy(ids).to(ids_dtype).to(dev),
            q.to(dev))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---- the formulas the spaces computed before the kernel ----
def _old_l2(data, sq_norms, q, ids):
    """RaBitQSpace / BQGSpace / f32 RawSpace ``gather_dists``, L2."""
    B, K = ids.shape
    safe = ids.clamp(0, data.shape[0] - 1).reshape(-1)
    dot = row_dots(data.index_select(0, safe).view(B, K, -1), q)
    q_sq = (q * q).sum(-1, keepdim=True)
    return torch.clamp(q_sq + sq_norms.index_select(0, safe).view(B, K)
                       - 2.0 * dot, min=0.0)


def _old_ip(data, q, ids):
    B, K = ids.shape
    safe = ids.clamp(0, data.shape[0] - 1).reshape(-1)
    return -row_dots(data.index_select(0, safe).view(B, K, -1), q)


def _old_rescore_d(data, sq_norms, metric, q, ids):
    """``exact_rescore``'s distances before the kernel."""
    safe = torch.where(ids >= 0, ids, torch.zeros_like(ids)).long()
    dot = row_dots(data[safe].float(), q)
    if metric == "ip":
        return -dot
    q_sq = (q * q).sum(-1, keepdim=True)
    return torch.clamp(q_sq + sq_norms[safe] - 2.0 * dot, min=0.0)


def _space(kind, metric, data):
    (C, D), dev = data.shape, data.device
    sq = sqnorms(data)
    if kind == "raw":
        return RawSpace.create(C, D, metric=metric, device=dev).fit(data)
    if kind == "rabitq":
        return RaBitQSpace.create(C, D, storage=(data, sq, torch.ones(
            C, dtype=torch.bool, device=dev), C), device=dev)
    sp = BQGSpace.create(C, D, metric=metric, device=dev)
    sp.data, sp.sq_norms = data, sq
    return sp


SPACES = [("raw", "l2"), ("raw", "ip"), ("bqg", "l2"), ("bqg", "ip"),
          ("rabitq", "l2")]


@pytest.mark.parametrize("kind,metric", SPACES)
def test_space_gather_dists_equal_the_former_formula(kind, metric):
    rng = np.random.default_rng(1)
    data, ids, q = _inputs(rng, 37, 19, 64, 300)
    sp = _space(kind, metric, data)
    got = sp.gather_dists(q, ids)
    want = (_old_ip(data, q, ids) if metric == "ip"
            else _old_l2(data, sqnorms(data), q, ids))
    _same_bits(got, want)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ref_equals_the_former_formula(metric):
    rng = np.random.default_rng(2)
    data, ids, q = _inputs(rng, 41, 23, 40, 500)
    sq = sqnorms(data)
    if metric == "ip":
        _same_bits(-gather_dot_ref(data, ids, q), _old_ip(data, q, ids))
    else:
        _same_bits(gather_dot_ref(data, ids, q, (q * q).sum(-1), sq),
                   _old_l2(data, sq, q, ids))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_rescore_equals_the_former_formula(metric):
    from alayalite_tpu_torch.ops.topk import topk_smallest

    rng = np.random.default_rng(3)
    data, ids, q = _inputs(rng, 29, 40, 32, 400)
    ids = torch.where(ids >= 400, torch.full_like(ids, -1), ids)
    sp = RawSpace.create(400, 32, metric=metric).fit(data)
    got_d, got_i = exact_rescore(sp, q, ids, 10)
    d = _old_rescore_d(sp.data, sp.sq_norms, sp.metric, q, ids)
    want_d, sel = topk_smallest(torch.where(ids >= 0, d, torch.full_like(
        d, float("inf"))), 10)
    want_i = torch.gather(ids, 1, sel)
    _same_bits(got_d, want_d)
    assert torch.equal(got_i, torch.where(torch.isfinite(want_d), want_i,
                                          torch.full_like(want_i, -1)))


def _old_slab(shards, sqs, n_total, metric, q, ids):
    """``DistSlab.gather_dists`` before the kernel: each shard's
    ``row_dots`` of the ids it owns, the partial distances summed."""
    total = torch.zeros(ids.shape)
    off = 0
    for data, sq in zip(shards, sqs):
        local = ids - off
        own = (local >= 0) & (local < data.shape[0])
        safe = torch.where(own, local, torch.zeros_like(local)).long()
        dot = row_dots(data[safe].float(), q)
        if metric == "ip":
            d = -dot
        else:
            d = torch.clamp((q * q).sum(-1, keepdim=True) + sq[safe]
                            - 2.0 * dot, min=0.0)
        total += torch.where(own, d, torch.zeros_like(d))
        off += data.shape[0]
    in_range = (ids >= 0) & (ids < n_total)
    return torch.where(in_range, total, torch.full_like(total, float("inf")))


def _old_rerank_d(q, x, x_sq, cand, metric):
    """``ops.distance._rerank_device``'s distances before the kernel."""
    safe = cand.clamp(min=0).long()
    dot = row_dots(x[safe].float(), q.float())
    if metric == "ip":
        return -dot
    return torch.clamp(sqnorms(q)[:, None] + x_sq[safe] - 2.0 * dot,
                       min=0.0)


def _slab(data, metric):
    from alayalite_tpu_torch.parallel.dist_graph import DistSlab

    shards = [data[:170].contiguous(), data[170:].contiguous()]
    return DistSlab(data=shards, sq_norms=[sqnorms(x) for x in shards],
                    n_total=data.shape[0] - 20, metric=metric)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("caller", ["slab", "rerank"])
def test_other_callers_equal_the_former_formula(caller, metric):
    """The sharded slab's ``gather_dists`` and the flat search's f32
    rerank call ``gather_dot`` once a shard / once, and give the bits of
    their former ``row_dots`` formulas."""
    from alayalite_tpu_torch.ops.distance import _rerank_device
    from alayalite_tpu_torch.ops.topk import topk_smallest

    rng = np.random.default_rng(8)
    data, ids, q = _inputs(rng, 31, 27, 48, 300)
    calls = gather_dot.calls
    if caller == "slab":
        slab = _slab(data, metric)
        got = slab.gather_dists(q, ids)
        assert gather_dot.calls == calls + 2
        _same_bits(got, _old_slab(slab.data, slab.sq_norms, slab.n_total,
                                  metric, q, ids))
        return
    cand = torch.where(ids >= 300, torch.full_like(ids, -1), ids)
    sq = sqnorms(data)
    got_d, got_i = _rerank_device(q, data, sq, cand, 10, metric)
    assert gather_dot.calls == calls + 1
    d = _old_rerank_d(q, data, sq, cand, metric)
    want_d, sel = topk_smallest(torch.where(cand >= 0, d, torch.full_like(
        d, float("inf"))), 10)
    _same_bits(got_d, want_d)
    want_i = torch.gather(cand, 1, sel)
    assert torch.equal(got_i, torch.where(torch.isfinite(want_d), want_i,
                                          torch.full_like(want_i, -1)))


def test_bf16_rerank_keeps_row_dots():
    from alayalite_tpu_torch.ops.distance import _rerank_device
    from alayalite_tpu_torch.ops.topk import topk_smallest

    rng = np.random.default_rng(9)
    data, ids, q = _inputs(rng, 12, 20, 32, 100)
    cand = torch.where(ids >= 100, torch.full_like(ids, -1), ids)
    x = data.to(torch.bfloat16)
    sq = sqnorms(x)
    calls = gather_dot.calls
    got_d, _ = _rerank_device(q, x, sq, cand, 5, "l2")
    assert gather_dot.calls == calls
    d = _old_rerank_d(q, x, sq, cand, "l2")
    want_d, _ = topk_smallest(torch.where(cand >= 0, d, torch.full_like(
        d, float("inf"))), 5)
    _same_bits(got_d, want_d)


def test_out_of_range_ids_read_the_first_and_last_rows():
    rng = np.random.default_rng(4)
    data, _, q = _inputs(rng, 3, 1, 16, 50)
    ids = torch.tensor([[-1, 0, 49, 50, -7, 1000]] * 3, dtype=torch.int32)
    clamped = torch.tensor([[0, 0, 49, 49, 0, 49]] * 3, dtype=torch.int32)
    sq = sqnorms(data)
    for args in ((), ((q * q).sum(-1), sq)):
        _same_bits(gather_dot(data, ids, q, *args),
                   gather_dot(data, clamped, q, *args))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_int32_and_int64_ids_give_the_same_result(metric):
    rng = np.random.default_rng(5)
    data, ids, q = _inputs(rng, 17, 33, 24, 200)
    args = () if metric == "ip" else ((q * q).sum(-1), sqnorms(data))
    _same_bits(gather_dot(data, ids, q, *args),
               gather_dot(data, ids.long(), q, *args))


def test_calls_count_and_cpu_launches_none():
    rng = np.random.default_rng(6)
    data, ids, q = _inputs(rng, 4, 5, 8, 20)
    calls, launches = gather_dot.calls, gather_dot.launches
    gather_dot(data, ids, q)
    gather_dot(data, ids, q, (q * q).sum(-1), sqnorms(data))
    assert gather_dot.calls == calls + 2
    assert gather_dot.launches == launches


def test_rabitq_counts_exact_rows_once_a_call():
    rng = np.random.default_rng(7)
    data, ids, q = _inputs(rng, 6, 9, 16, 100)
    sp = _space("rabitq", "l2", data)
    rows, calls = counters.exact_rows, gather_dot.calls
    sp.gather_dists(q, ids)
    assert counters.exact_rows == rows + 6 * 9
    assert gather_dot.calls == calls + 1


def test_captured_counts_carry_gather_dot():
    counts = captured.counts()
    assert (gather_dot, "calls", None) in counts
    assert (gather_dot, "launches", None) in counts


def test_empty_inputs():
    data = torch.zeros((10, 8))
    out = gather_dot(data, torch.zeros((0, 4), dtype=torch.int32),
                     torch.zeros((0, 8)))
    assert out.shape == (0, 4)
    out = gather_dot(data, torch.zeros((3, 0), dtype=torch.int64),
                     torch.zeros((3, 8)))
    assert out.shape == (3, 0)


@pytest.mark.parametrize("case", ["data_dtype", "ids_dtype", "q_shape",
                                  "q_sq_alone", "x_sq_shape",
                                  "not_contiguous", "no_rows"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    data, ids, q = torch.zeros((10, 8)), torch.zeros(
        (3, 4), dtype=torch.int32), torch.zeros((3, 8))
    q_sq, x_sq = torch.zeros(3), torch.zeros(10)
    bad = {"data_dtype": lambda: gather_dot(data.double(), ids, q),
           "ids_dtype": lambda: gather_dot(data, ids.short(), q),
           "q_shape": lambda: gather_dot(data, ids, q[:, :4]),
           "q_sq_alone": lambda: gather_dot(data, ids, q, q_sq),
           "x_sq_shape": lambda: gather_dot(data, ids, q, q_sq, x_sq[:5]),
           "not_contiguous": lambda: gather_dot(
               data, torch.zeros((4, 3), dtype=torch.int32).T, q),
           "no_rows": lambda: gather_dot(torch.zeros((0, 8)), ids, q)}
    with pytest.raises((TypeError, ValueError)):
        bad[case]()


# ---- on the card ----
def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _f64_ref(data, ids, q, metric):
    """The same distances in float64 from the same f32 inputs."""
    C = data.shape[0]
    rows = data.double()[ids.long().clamp(0, C - 1)]
    dot = (rows * q.double()[:, None, :]).sum(-1)
    if metric == "ip":
        return dot, torch.zeros_like(dot)
    scale = (q.double() ** 2).sum(-1)[:, None] + (rows ** 2).sum(-1)
    return torch.clamp(scale - 2.0 * dot, min=0.0), scale


# (B, K, D): the 1-bit search's final re-score and hop, bsq8's final pool
# over a served batch, a ragged K under a group's rows, GIST's D, D whose
# slices split unevenly over the lanes, D with no 16-byte rows, D past
# one pass of 8 slices a lane
GPU_SHAPES = [(4096, 512, 128), (4096, 8, 128), (52, 72, 128), (7, 5, 96),
              (33, 3, 960), (65, 17, 100), (19, 11, 98), (9, 6, 1536)]


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("B,K,D", GPU_SHAPES)
def test_kernel_against_float64(B, K, D, metric):
    dev = _gpu()
    rng = np.random.default_rng(B + K + D)
    C = 100_000 if D <= 128 else 5000
    data, ids, q = _inputs(rng, B, K, D, C, dev)
    args = () if metric == "ip" else ((q * q).sum(-1), sqnorms(data))
    launches = gather_dot.launches
    got = gather_dot(data, ids, q, *args)
    torch.cuda.synchronize()
    assert gather_dot.launches == launches + 1
    want, scale = _f64_ref(data, ids, q, metric)
    err = (got.double() - want).abs()
    if metric == "ip":
        # f32 sums of D products: a few ulps of the sum of |products|
        rows = data.double()[ids.long().clamp(0, C - 1)]
        scale = (rows.abs() * q.double().abs()[:, None, :]).sum(-1)
    assert bool((err <= 1e-5 * scale + 1e-6).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("B,K", [(4096, 512), (4096, 8), (52, 72), (3, 2)])
def test_kernel_has_the_bits_of_the_plain_version_at_d128(B, K, metric):
    """At D = 128 the kernel sums in the order of PyTorch's CUDA sum over
    the last axis, so it gives the bits of the chain it replaced
    (``gather_dot_ref`` on the card: index_select, ``row_dots``, the
    epilogue), and fits and searches read what they read before it."""
    dev = _gpu()
    rng = np.random.default_rng(B + K)
    data, ids, q = _inputs(rng, B, K, 128, 1_000_000 if B > 64 else 20_000,
                           dev)
    args = () if metric == "ip" else ((q * q).sum(-1), sqnorms(data))
    _same_bits(gather_dot(data, ids, q, *args),
               gather_dot_ref(data, ids, q, *args))


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_a_pair_has_the_same_bits_in_any_batch(metric):
    """Splits of 512 / 54 / 1 queries, K 8 against K 512, int64 ids, and
    the word-by-word loads of an unaligned copy: the same f32 bits."""
    dev = _gpu()
    rng = np.random.default_rng(11)
    data, ids, q = _inputs(rng, 4096, 512, 128, 1_000_000, dev)

    def call(d, i, qq):
        if metric == "ip":
            return gather_dot(d, i, qq)
        return gather_dot(d, i, qq, (qq * qq).sum(-1), sqnorms(data))

    full = call(data, ids, q)
    for rows in (512, 54, 1):
        parts = torch.cat([call(data, ids[lo:lo + rows], q[lo:lo + rows])
                           for lo in range(0, 4096, rows)])
        _same_bits(parts, full)
    _same_bits(call(data, ids[:, :8].contiguous(), q), full[:, :8])
    _same_bits(call(data, ids.long(), q), full)
    skew = torch.empty(data.numel() + 1, device=dev)[1:].view(data.shape)
    skew.copy_(data)
    assert skew.data_ptr() % 16 != 0
    _same_bits(call(skew, ids, q), full)


@pytest.mark.gpu
def test_captured_replay_equals_uncaptured_call():
    dev = _gpu()
    rng = np.random.default_rng(12)
    data, ids, q = _inputs(rng, 4096, 512, 128, 200_000, dev)
    q_sq, x_sq = (q * q).sum(-1), sqnorms(data)
    want = gather_dot(data, ids, q, q_sq, x_sq)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gather_dot(data, ids, q, q_sq, x_sq)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gather_dot(data, ids, q, q_sq, x_sq)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        _same_bits(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,metric", SPACES + [
    ("rescore", "l2"), ("rescore", "ip"), ("slab", "l2"), ("rerank", "l2"),
    ("rerank", "ip")])
def test_spaces_launch_the_kernel(kind, metric):
    from alayalite_tpu_torch.ops.distance import _rerank_device

    dev = _gpu()
    rng = np.random.default_rng(13)
    data, ids, q = _inputs(rng, 300, 64, 128, 20_000)
    ids = ids.clamp(max=19_999)
    launched = 1
    if kind == "slab":
        sp, cpu, launched = _slab(data.to(dev), metric), _slab(data,
                                                                 metric), 2
        run = (lambda s, qq, ii: s.gather_dists(qq, ii))
    elif kind == "rerank":
        sp, cpu = data.to(dev), data
        run = (lambda x, qq, ii: _rerank_device(qq, x, sqnorms(x), ii, 10,
                                                metric)[0])
    elif kind == "rescore":
        sp = RawSpace.create(20_000, 128, metric=metric, device=dev).fit(
            data.to(dev))
        cpu = RawSpace.create(20_000, 128, metric=metric).fit(data)
        run = (lambda s, qq, ii: exact_rescore(s, qq, ii, 10)[0])
    else:
        sp, cpu = _space(kind, metric, data.to(dev)), _space(kind, metric,
                                                             data)
        run = (lambda s, qq, ii: s.gather_dists(qq, ii))
    launches = gather_dot.launches
    got = run(sp, q.to(dev), ids.to(dev))
    torch.cuda.synchronize()
    assert gather_dot.launches == launches + launched
    want = run(cpu, q, ids)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_bf16_rows_keep_the_former_path():
    dev = _gpu()
    rng = np.random.default_rng(14)
    data, ids, q = _inputs(rng, 64, 32, 128, 5000, dev)
    sp = RawSpace.create(5000, 128, storage_dtype="bfloat16",
                         device=dev).fit(data)
    launches = gather_dot.launches
    sp.gather_dists(q, ids.clamp(0, 4999))
    exact_rescore(sp, q, ids.clamp(max=4999), 10)
    torch.cuda.synchronize()
    assert gather_dot.launches == launches
