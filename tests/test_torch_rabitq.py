"""The port's RaBitQ against the JAX package's: the block quantization,
the hop's estimate (``estimate_many`` through ``block_diagdot``'s plain
version on the CPU), the port's own fit with insert / remove / compact /
save / load (read back by JAX too), the 1-bit ef boost and result pool,
and the QG builder's "twohop" pools. JAX-built indices searched by the
port: ``tests/test_torch_rabitq_cross.py`` (a file of its own, so that
the JAX fit runs on another test worker)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alayalite_tpu import Index as JaxIndex
from alayalite_tpu.index.build_phases import \
    twohop_pool_dev as jax_twohop_pool_dev
from alayalite_tpu.spaces.rabitq import RaBitQSpace as JaxRaBitQ
from alayalite_tpu.spaces.rabitq import _quantize_block as jax_quantize_block
from alayalite_tpu.spaces.rabitq import _unpack_bits_jnp as jax_unpack_bits
from alayalite_tpu.spaces.raw import RawSpace as JaxRawSpace
from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.index import qg as port_qg
from alayalite_tpu_torch.index.qg import QGBuilder
from alayalite_tpu_torch.index.build_phases import twohop_pool_dev
from alayalite_tpu_torch.ops.diagdot import block_diagdot
from alayalite_tpu_torch.spaces.rabitq import (RaBitQSpace, binary_dot_ref,
                                               quantize_block, unpack_codes)
from alayalite_tpu_torch.spaces.raw import RawSpace
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

torch.set_num_threads(2)

DIM = 32


def _graph_like(rng, n, dim):
    """Rows in tight groups, each row's 32 neighbors drawn from its group
    (and a few −1 slots and one repeated row), as a graph's blocks hold."""
    centers = rng.normal(size=(n // 40, dim)).astype(np.float32) * 3.0
    data = (centers[np.arange(n) % centers.shape[0]]
            + rng.normal(size=(n, dim)).astype(np.float32))
    data[7] = data[3]                       # a zero residual
    same = np.arange(n)[:, None] % centers.shape[0]
    nbrs = (same + centers.shape[0] * rng.integers(
        0, n // centers.shape[0], size=(n, 32))).astype(np.int32)
    nbrs[::5, -4:] = -1
    nbrs[3, 0] = 7
    return data, nbrs


@pytest.mark.parametrize("bits", [1, 2])
def test_unpack_codes_match_jax_bit_planes(bits):
    """The table-lookup unpack against JAX's ``_unpack_bits_jnp`` of each
    plane: codes 128 + b or 128 + p0 + 2·p1, exactly."""
    rng = np.random.default_rng(11)
    packed = rng.integers(0, 256, size=(3, 32, bits * 16), dtype=np.uint8)
    e = 128
    planes = [np.asarray(jax_unpack_bits(jnp.asarray(p), e)).astype(np.int32)
              for p in np.split(packed, bits, axis=-1)]
    want = 128 + planes[0] + (2 * planes[1] if bits == 2 else 0)
    got = unpack_codes(torch.as_tensor(packed), bits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


@pytest.mark.parametrize("bits", [1, 2])
def test_quantize_block_matches_jax(bits):
    """Codes equal to JAX's wherever the rotated residual is not on a code
    boundary (1 bit: |r'| > 1e-6; 2 bits: r'/step + 1.5 farther than 1e-4
    from a half-integer), and f_add / f_rescale to rtol 1e-4 on every row
    whose codes all agree (at least 0.99 of the rows)."""
    rng = np.random.default_rng(11 + bits)
    data, nbrs = _graph_like(rng, 400, 64)
    rot = JaxRaBitQ.create(400, 64).rot
    us = np.arange(400, dtype=np.int32)
    jc, jfa, jfr = (np.asarray(a) for a in jax_quantize_block(
        jnp.asarray(data), rot, jnp.asarray(us), jnp.asarray(nbrs),
        bits=bits))
    pc, pfa, pfr = (a.numpy() for a in quantize_block(
        torch.as_tensor(data), torch.as_tensor(np.asarray(rot)),
        torch.as_tensor(us), torch.as_tensor(nbrs), bits=bits))
    assert pc.shape == jc.shape == (400, 32, bits * 64)
    # the rotated residuals, to find the codes that sit on a boundary
    safe = np.where(nbrs >= 0, nbrs, 0)
    r = data[safe] - data[us][:, None, :]
    rrot = r @ np.asarray(rot).T
    if bits == 1:
        firm = np.abs(rrot) > 1e-6
    else:
        step = 0.9957 * np.maximum(
            np.linalg.norm(r, axis=-1, keepdims=True) / np.sqrt(64), 1e-30)
        t = rrot / step + 1.5
        firm = np.abs(t - np.floor(t) - 0.5) > 1e-4
        firm = np.concatenate([firm, firm], axis=-1)
    firm &= (nbrs >= 0)[:, :, None]
    assert firm.mean() > 0.75
    assert (pc[firm] == jc[firm]).all()
    same_rows = (pc == jc).all(-1)
    assert same_rows.mean() >= 0.99, same_rows.mean()
    np.testing.assert_allclose(pfa[same_rows], jfa[same_rows], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pfr[same_rows], jfr[same_rows], rtol=1e-4,
                               atol=1e-4)
    # the repeated row: factors 0, so its estimate is d²(q, u)
    assert pfa[3, 0] == 0.0 and pfr[3, 0] == 0.0


@pytest.mark.parametrize("bits", [1, 2])
def test_estimate_many_matches_jax_estimate_block(bits):
    """JAX's own blocks loaded into the port; the hop's estimate for M = 4
    popped nodes a query (one ``block_diagdot`` call on the unpacked codes,
    its plain version here) against JAX's estimate_block node by node:
    atol 1e-3 of the estimates' scale. The dot itself against
    ``binary_dot_ref`` (the planes apart, as JAX sums them)."""
    rng = np.random.default_rng(3)
    data, nbrs = _graph_like(rng, 500, 32)
    jsp = JaxRaBitQ.create(500, 32, bits=bits).fit(data).update_neighbors(
        nbrs)
    sp = RaBitQSpace.load_arrays(jsp.save_arrays())
    q = (data[rng.integers(0, 500, size=64)]
         + 0.3 * rng.normal(size=(64, 32))).astype(np.float32)
    u = rng.integers(0, 500, size=(64, 4)).astype(np.int32)
    qj = jnp.asarray(q)
    qrot, qsum = jsp.rotate_queries(qj)
    want_e, want_i = [], []
    for m in range(4):
        uj = jnp.asarray(u[:, m])
        dc = jsp.gather_dists(qj, uj[:, None])[:, 0]
        e, i = jsp.estimate_block(qrot, qsum, dc, uj)
        want_e.append(np.asarray(e))
        want_i.append(np.asarray(i))
    want_e = np.concatenate(want_e, 1)
    want_i = np.concatenate(want_i, 1)
    calls = block_diagdot.calls
    ctx = sp.query_ctx(torch.as_tensor(q))
    est, ids = sp.estimate_many(ctx, torch.as_tensor(u))
    assert block_diagdot.calls == calls + 1
    np.testing.assert_array_equal(ids.numpy(), want_i)
    scale = float(np.abs(want_e).max())
    np.testing.assert_allclose(est.numpy(), want_e, rtol=0,
                               atol=1e-3 * scale)
    packed = sp.nbr_bits[torch.as_tensor(u).long().reshape(-1)].view(
        64, 4 * 32, -1)
    dot = block_diagdot(unpack_codes(packed, bits), ctx[1])
    ref = binary_dot_ref(packed, ctx[0] @ sp.rot.T, bits)
    np.testing.assert_allclose(dot.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("quant", ["rabitq", "rabitq2"])
def test_port_fit_insert_remove_save_load(tmp_path, quant):
    """The port's own fit: inserted rows come back as their own top-1;
    removed ids never come back, also after compact; save/load keeps the
    ids; the space shares the raw slab throughout."""
    ds = random_dataset(n=2000, dim=DIM, n_queries=64, seed=4)
    gt = calc_gt(ds.data, ds.queries, 10, device="cpu")
    idx = Index("r", IndexParams(index_type="hnsw", capacity=2200,
                                 quantization_type=quant,
                                 ef_construction=64), device="cpu")
    idx.fit(ds.data)
    eng = idx._engine
    assert eng.search_space.data is eng.space.data
    assert eng.search_space.nbr_bits.shape[0] == 2200
    assert calc_recall(idx.batch_search(ds.queries, 10, ef_search=32),
                       gt) >= 0.9
    rng = np.random.default_rng(7)
    new = (ds.data[rng.integers(0, 2000, size=100)]
           + 0.05 * rng.normal(size=(100, DIM))).astype(np.float32)
    ids = idx.insert(new)
    np.testing.assert_array_equal(ids, np.arange(2000, 2100))
    assert eng.search_space.num == eng.space.num == 2100
    got = idx.batch_search(new, 1, ef_search=64)[:, 0]
    assert (got == ids).mean() >= 0.95
    # every row the new nodes point at was re-quantized with its new row
    nb = eng.graph.nbrs[torch.as_tensor(ids).long()]
    np.testing.assert_array_equal(
        nb.numpy(), eng.search_space.nbr_ids[torch.as_tensor(ids).long()]
        .numpy())
    dead = np.arange(0, 2000, 4)
    idx.remove(dead)
    eng.compact()
    live_rows = eng.graph.nbrs[torch.as_tensor(np.setdiff1d(
        np.arange(2100), dead)).long()]
    assert not np.isin(live_rows.numpy(), dead).any()
    res = idx.batch_search(ds.queries, 10, ef_search=64)
    assert not np.isin(res, dead).any()
    idx.save(str(tmp_path / "r"))
    back = Index.load(str(tmp_path), "r", device="cpu")
    np.testing.assert_array_equal(
        back.batch_search(ds.queries, 10, ef_search=64), res)
    # the loaded space shares the raw slab too, so it inserts as a fit's
    beng = back._engine
    assert beng.search_space.data is beng.space.data
    more = back.insert(new[:16] + 0.01)
    assert beng.search_space.num == beng.space.num == 2116
    assert (back.batch_search(new[:16] + 0.01, 1, ef_search=64)[:, 0]
            == more).mean() >= 0.9
    again = JaxIndex.load(str(tmp_path), "r")
    assert (np.asarray(again.batch_search(new[:16], 1, ef_search=64))[:, 0]
            == ids[:16]).mean() >= 0.9


def test_ef_boost_and_result_pool():
    """1-bit at 8,000 x 128, ef 32: the default boost (4) reads above no
    boost, and with no boost the result pool reads well above the same
    search without it (the JAX package's round-5 case: 0.59 -> 0.93)."""

    class NoPool:
        """The space seen without its bit width: the search keeps no
        result pool; estimates are the space's own."""
        bits = 0

        def __init__(self, sp):
            self._sp = sp

        def __getattr__(self, name):
            return getattr(self._sp, name)

    from alayalite_tpu_torch.index.search import block_search_device

    ds = random_dataset(n=8000, dim=128, n_queries=128, seed=29)
    gt = calc_gt(ds.data, ds.queries, 10, device="cpu")
    idx = Index("b", IndexParams(index_type="hnsw", capacity=8000,
                                 quantization_type="rabitq"), device="cpu")
    idx.fit(ds.data)
    eng = idx._engine
    assert eng.params.rabitq_ef_boost == 4.0
    rec_boost = calc_recall(idx.batch_search(ds.queries, 10, ef_search=32),
                            gt)
    eng.params.rabitq_ef_boost = 1.0
    rec_pool = calc_recall(idx.batch_search(ds.queries, 10, ef_search=32),
                           gt)
    q = eng.search_space.prep_query(torch.as_tensor(ds.queries))
    _, ids = block_search_device(
        NoPool(eng.search_space), eng.graph.eps, q, k=10, ef=32,
        valid=eng.space.valid, n_expand=eng.params.beam_expand,
        seed_sample=eng._seed_scan_arrays())
    rec_nopool = calc_recall(ids.numpy(), gt)
    assert rec_boost >= rec_pool >= rec_nopool + 0.1, (
        rec_boost, rec_pool, rec_nopool)
    assert rec_boost >= 0.95


def test_twohop_pool_matches_jax():
    """twohop_pool_dev on one kNN graph: the ids JAX's gives (equal
    distances aside) and its distances to 1e-5."""
    rng = np.random.default_rng(2)
    data = rng.normal(size=(600, 16)).astype(np.float32)
    d = ((data[:, None] - data[None]) ** 2).sum(-1)
    knn = np.argsort(d, axis=1)[:, 1:13].astype(np.int32)
    knn[::9, -2:] = -1
    jsp = JaxRawSpace.create(600, 16).fit(data)
    jd, ji = (np.asarray(a) for a in jax_twohop_pool_dev(
        jsp, jnp.asarray(knn), ef=40, n=600, chunk=256))
    sp = RawSpace.create(600, 16).fit(torch.as_tensor(data))
    pd_, pi = (a.numpy() for a in twohop_pool_dev(
        sp, torch.as_tensor(knn), ef=40, n=600, chunk=256))
    np.testing.assert_allclose(pd_, jd, rtol=1e-5, atol=1e-5)
    assert (pi == ji).mean() >= 0.999


@pytest.mark.parametrize("quant", ["bsq8", "rabitq2"])
def test_twohop_pools_against_beam_pools(monkeypatch, quant):
    """QGBuilder(pool_mode="twohop") builds graphs that read recall@10
    within 0.02 of the default beam pools."""
    ds = random_dataset(n=3000, dim=32, n_queries=128, seed=13, clusters=12)
    gt = calc_gt(ds.data, ds.queries, 10, device="cpu")
    recall = {}
    for mode in ("beam", "twohop"):
        monkeypatch.setattr(port_qg, "QGBuilder", functools.partial(
            QGBuilder, pool_mode=mode))
        idx = Index(mode, IndexParams(index_type="hnsw", capacity=3000,
                                      quantization_type=quant,
                                      ef_construction=128), device="cpu")
        idx.fit(ds.data)
        recall[mode] = calc_recall(
            idx.batch_search(ds.queries, 10, ef_search=32), gt)
        monkeypatch.undo()
    assert recall["beam"] >= 0.85, recall
    assert recall["twohop"] >= recall["beam"] - 0.02, recall
