"""unique_topk, the block search's final selection: the plain version against
the duplicate net and top k it replaced in ``_block_beam_search`` and
against a row-by-row model of the kernel's own steps (first copies through
a set, keys as ordered integers, the k least by (key, column)), the
wrapper's checks, and (with a CUDA device) the hand-written kernel against
the plain version bit for bit, and the block search with the kernel against
the same search with the plain version.

The rows are quarter-integer distances, so ties stand everywhere, with
copies planted as the search makes them: two live copies of an id in the
pool, a popped node in both the pool and the result pool (the last k
columns), a later copy at a smaller distance; and holes (−1, with a finite
or an inf distance), inf distances, rows of all −1, rows with fewer than k
live ids, and ids whose ``valid`` entry is False.

No JAX import: the card's cases run where JAX is absent,
``python -m pytest --noconftest -m gpu tests/test_torch_unique_topk.py``."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.ops.topk import topk_smallest
from alayalite_tpu_torch.ops.unique_topk import (MAX_W, unique_topk,
                                                 unique_topk_ref)

KEY_INF, KEY_NAN = np.uint32(0xFF800000), np.uint32(0xFFFFFFFE)


def _rows(rng, B, W, k, C, specials=False):
    """(d f32 [B, W], ids i32 [B, W], valid bool [C]) as numpy arrays."""
    d = rng.integers(0, 64, size=(B, W)).astype(np.float32) / 4
    ids = rng.integers(0, C, size=(B, W)).astype(np.int32)
    r = np.arange(B)
    # pool-pool copies at random columns, at the first copy's distance
    for _ in range(max(1, W // 16)):
        i, j = rng.integers(0, W, size=(2, B))
        ids[r, j], d[r, j] = ids[r, i], d[r, i]
    # a later copy at a smaller distance than the first
    i = rng.integers(0, max(1, W // 2), size=B)
    j = rng.integers(W // 2, W, size=B)
    ids[r, j], d[r, i], d[r, j] = ids[r, i], d[r, i] + 4, d[r, i] + 1
    # the result pool (the last k columns) repeats pool ids, popped nodes
    if W > k:
        src = rng.integers(0, W - k, size=(B, k))
        take = rng.random((B, k)) < 0.5
        ids[:, W - k:] = np.where(take, ids[r[:, None], src], ids[:, W - k:])
        d[:, W - k:] = np.where(take, d[r[:, None], src], d[:, W - k:])
    # ties at the k-th place: 3k entries at one small distance
    tie = np.flatnonzero(rng.random(B) < 0.25)
    cols = rng.integers(0, W, size=(tie.size, min(W, 3 * k)))
    d[tie[:, None], cols] = 0.5
    # inf distances, holes (a re-scored id 0's distance or inf), ids past C
    d[rng.random((B, W)) < 0.02] = np.inf
    hole = rng.random((B, W)) < 0.1
    ids[hole] = -1
    d[hole & (rng.random((B, W)) < 0.5)] = np.inf
    ids[rng.random((B, W)) < 0.005] = C + 7
    # rows of all -1, rows with fewer than k live ids
    ids[rng.random(B) < 0.05] = -1
    few = rng.random(B) < 0.1
    ids[few[:, None] & (rng.random((B, W)) > (k / 2) / W)] = -1
    if specials:
        pick = rng.random((B, W))
        d[pick < 0.03] = -0.0
        d[(pick >= 0.03) & (pick < 0.05)] = np.nan
        d[(pick >= 0.05) & (pick < 0.06)] = -np.inf
        d[(pick >= 0.06) & (pick < 0.08)] = -d[(pick >= 0.06) & (pick < 0.08)]
    valid = rng.random(C) > 0.1
    return d, ids, valid


def _tensors(d, ids, valid, with_valid, dev="cpu"):
    return (torch.from_numpy(d).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(valid).to(dev) if with_valid else None)


def _inline_net(d, ids, k, valid):
    """``_block_beam_search``'s final lines before the kernel."""
    ok = ids >= 0
    if valid is not None:
        ok &= valid[ids.clamp(0, valid.shape[0] - 1).long()]
    W = ids.shape[1]
    tril = torch.tril(torch.ones((W, W), dtype=torch.bool), -1)
    dup = ((ids[:, :, None] == ids[:, None, :]) & tril[None]).any(2)
    out_d, sel = topk_smallest(
        torch.where(ok & ~dup, d, torch.full_like(d, float("inf"))), k)
    out_i = torch.gather(ids, 1, sel)
    return out_d, torch.where(torch.isfinite(out_d), out_i,
                              torch.full_like(out_i, -1))


def _order_key(d):
    """The kernel's key: f32 bits as an unsigned integer in the float
    order, -0.0 as +0.0, every NaN after +inf."""
    u = d.view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    key[d == 0] = 0x80000000
    key[np.isnan(d)] = KEY_NAN
    return key


def _kernel_model(d, ids, k, valid):
    """The kernel's steps row by row: first copies of live ids (a set, in
    column order), their keys, +inf for the rest, the k least by (key,
    column); a winner keyed +inf reads +inf, any other its own bits."""
    B, W = ids.shape
    k = min(k, W)
    keys = _order_key(d)
    out_d = np.empty((B, k), np.float32)
    out_i = np.empty((B, k), np.int32)
    for b in range(B):
        seen = set()
        key = np.full(W, KEY_INF, np.uint32)
        for c in range(W):
            i = int(ids[b, c])
            if i < 0 or (valid is not None
                         and not valid[min(i, valid.shape[0] - 1)]):
                continue
            if i not in seen:
                seen.add(i)
                key[c] = keys[b, c]
        order = np.lexsort((np.arange(W), key))[:k]
        for r, c in enumerate(order):
            v = np.float32(np.inf) if key[c] == KEY_INF else d[b, c]
            out_d[b, r] = v
            out_i[b, r] = ids[b, c] if np.isfinite(v) else -1
    return out_d, out_i


def _same_bits(got, want):
    gd, gi = (t.cpu() for t in got)
    wd, wi = (torch.as_tensor(t) for t in want)
    assert gd.shape == wd.shape and gi.shape == wi.shape
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32
    assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))
    assert torch.equal(gi, wi)


# (B, W, k, with valid): the 1-bit search's slice, bsq8's, the fit's pools
# (k = W = ef), the inserts' (k = r = 32), a served batch; and ragged rows
# across the plain version's 256-row chunks, W under a warp, k = W = 1
CPU_CASES = [(64, 522, 10, True), (64, 64, 10, True), (40, 100, 100, False),
             (48, 64, 32, True), (52, 64, 10, True), (300, 40, 7, True),
             (17, 5, 3, False), (9, 1, 1, True)]


@pytest.mark.parametrize("B,W,k,with_valid", CPU_CASES)
def test_plain_version_equals_the_inline_net(B, W, k, with_valid):
    rng = np.random.default_rng(B * 31 + W + k)
    args = _tensors(*_rows(rng, B, W, k, 4 * W), with_valid)
    want = _inline_net(args[0], args[1], k, args[2])
    _same_bits(unique_topk_ref(args[0], args[1], k, args[2]), want)
    _same_bits(unique_topk(args[0], args[1], k, args[2]), want)


@pytest.mark.parametrize("B,W,k,with_valid", CPU_CASES)
@pytest.mark.parametrize("specials", [False, True])
def test_plain_version_equals_the_kernels_steps(B, W, k, with_valid,
                                                specials):
    rng = np.random.default_rng(B + W * 7 + k + specials)
    d, ids, valid = _rows(rng, B, W, k, 4 * W, specials)
    t = _tensors(d, ids, valid, with_valid)
    got = unique_topk_ref(t[0], t[1], k, t[2])
    _same_bits(got, _kernel_model(d, ids, k, valid if with_valid else None))


def test_first_copy_wins_and_ties_keep_column_order():
    d = torch.tensor([[3.0, 1.0, 2.0, 0.5, 1.0, 1.0, 0.0]])
    ids = torch.tensor([[7, 9, 7, 9, 4, 5, -1]], dtype=torch.int32)
    out_d, out_i = unique_topk(d, ids, 5)
    # 9 at column 3 and 7 at column 2 are later copies; -1 is out
    assert out_i.tolist() == [[9, 4, 5, 7, -1]]
    assert out_d.tolist() == [[1.0, 1.0, 1.0, 3.0, float("inf")]]
    valid = torch.tensor([True] * 9 + [False])
    assert unique_topk(d, ids, 3, valid)[1].tolist() == [[4, 5, 7]]


def test_k_past_the_row_width_clamps():
    rng = np.random.default_rng(4)
    d, ids, valid = _tensors(*_rows(rng, 6, 8, 4, 32), True)
    out_d, out_i = unique_topk(d, ids, 20, valid)
    assert out_d.shape == out_i.shape == (6, 8)
    _same_bits((out_d, out_i), _inline_net(d, ids, 8, valid))


def test_wrapper_counts_calls_and_launches_nothing_on_the_cpu():
    rng = np.random.default_rng(2)
    d, ids, valid = _tensors(*_rows(rng, 5, 64, 10, 256), True)
    calls, launches = unique_topk.calls, unique_topk.launches
    unique_topk(d, ids, 10, valid)
    assert unique_topk.calls == calls + 1
    assert unique_topk.launches == launches


def test_block_search_selects_through_unique_topk():
    """Each slice of the block search ends in one ``unique_topk`` call."""
    from alayalite_tpu_torch import Client

    x = np.random.default_rng(1).normal(size=(600, 16)).astype(np.float32)
    idx = Client(device="cpu").create_index(
        "u", quantization_type="bsq8", capacity=700, max_nbrs=16)
    idx.fit(x)
    calls = unique_topk.calls
    ids = idx.batch_search(x[:5], 5, ef_search=32)
    assert unique_topk.calls == calls + 1
    assert (ids[:, 0] == np.arange(5)).all()
    assert all(len(set(row)) == len(row) for row in ids.tolist())


@pytest.mark.parametrize("what", ["d_dtype", "ids_dtype", "shape",
                                  "valid_dtype", "valid_empty", "k_0",
                                  "strided", "device", "wide"])
def test_wrapper_raises_on_bad_inputs(what):
    rng = np.random.default_rng(3)
    d, ids, valid = _tensors(*_rows(rng, 5, 64, 10, 256), True)
    k, err = 10, TypeError
    if what == "d_dtype":
        d = d.double()
    elif what == "ids_dtype":
        ids = ids.long()
    elif what == "shape":
        ids = ids[:, :32].contiguous()
    elif what == "valid_dtype":
        valid = valid.to(torch.uint8)
    elif what == "valid_empty":
        valid = valid[:0]
    elif what == "k_0":
        k, err = 0, ValueError
    elif what == "strided":
        d, err = torch.cat([d, d], 1)[:, ::2], ValueError
    elif what == "device":
        d, err = d.to("meta"), ValueError
    elif what == "wide":
        d = torch.zeros((1, MAX_W + 1))
        ids = torch.zeros((1, MAX_W + 1), dtype=torch.int32)
        err = ValueError
    with pytest.raises(err):
        unique_topk(d, ids, k, valid)


# ---------------------------------------------------------------- the card

# (B, W, k, with valid): the path's shapes, then specials (NaN, -0.0,
# -inf), W under a warp, wide rows (fewer rows a block), k = W = 1
GPU_CASES = [(4096, 522, 10, True, False), (4096, 64, 10, True, False),
             (4096, 100, 100, False, False), (4096, 64, 32, True, False),
             (52, 64, 10, True, False), (1024, 522, 10, True, True),
             (333, 5, 3, True, True), (64, 3000, 10, True, False),
             (8, 16384, 64, True, True), (100, 1, 1, True, False)]


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,W,k,with_valid,specials", GPU_CASES)
def test_kernel_matches_plain_version(B, W, k, with_valid, specials):
    dev = _gpu()
    rng = np.random.default_rng(B + W + k)
    d, ids, valid = _rows(rng, B, W, k, 4 * W, specials)
    on_card = _tensors(d, ids, valid, with_valid, dev)
    launches = unique_topk.launches
    got = unique_topk(on_card[0], on_card[1], k, on_card[2])
    torch.cuda.synchronize()
    assert unique_topk.launches == launches + 1
    cpu = _tensors(d, ids, valid, with_valid)
    _same_bits(got, unique_topk_ref(cpu[0], cpu[1], k, cpu[2]))


@pytest.mark.gpu
def test_captured_replay_equals_uncaptured_call():
    dev = _gpu()
    rng = np.random.default_rng(21)
    d, ids, valid = _tensors(*_rows(rng, 4096, 522, 10, 2048), True, dev)
    want = unique_topk(d, ids, 10, valid)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        unique_topk(d, ids, 10, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = unique_topk(d, ids, 10, valid)
    for _ in range(2):
        out[0].zero_()
        out[1].zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["rabitq", "bsq8"])
def test_block_search_device_matches_the_plain_path(quant, monkeypatch):
    """A small index searched on the card, each slice a captured replay
    with the kernel, against the same slices uncaptured with the plain
    version in its place: the same ids and distances, bit for bit."""
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.index import captured, search
    from alayalite_tpu_torch.utils.datasets import random_dataset

    _gpu()
    ds = random_dataset(n=4000, dim=64, n_queries=300, seed=5)
    idx = Index("u", IndexParams(quantization_type=quant, capacity=4100,
                                 ef_construction=64))
    idx.fit(ds.data)
    idx.remove(list(range(0, 4000, 9)))
    eng = idx._engine
    launches = unique_topk.launches
    i_k, d_k = eng._batch_search_impl(ds.queries, 10, 32)
    torch.cuda.synchronize()
    assert unique_topk.launches > launches
    monkeypatch.setattr(search, "unique_topk", unique_topk_ref)
    with captured.eager():
        i_p, d_p = eng._batch_search_impl(ds.queries, 10, 32)
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert not bool(((i_k >= 0) & (i_k % 9 == 0)).any())
