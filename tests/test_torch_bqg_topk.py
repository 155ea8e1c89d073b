"""The port's block-SQ8 space and top-k merges against the JAX package on
the same numpy inputs: byte-identical codes, the estimator within
rtol 1e-5 / atol 1e-3 (f32 sums in another order), and identical merge /
pop results on rows with deliberate ties and duplicates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alayalite_tpu.index import search as jsearch
from alayalite_tpu.ops import topk as jtopk
from alayalite_tpu.spaces import bqg as jbqg
from alayalite_tpu_torch.index import search as tsearch
from alayalite_tpu_torch.ops import topk as ttopk
from alayalite_tpu_torch.spaces import bqg as tbqg

METRICS = ["l2", "ip", "cos"]


def _jax_space(metric, n=96, dim=40, degree=8, seed=0):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(n, dim)) * 3 + 1).astype(np.float32)
    nbrs = rng.integers(0, n, size=(n, degree)).astype(np.int32)
    nbrs[rng.random(size=nbrs.shape) < 0.2] = -1
    sp = jbqg.BQGSpace.create(n, dim, metric=metric, degree=degree).fit(data)
    return sp.update_neighbors(nbrs), nbrs, rng


@pytest.mark.parametrize("metric", METRICS)
def test_encode_block_matches_jax(metric):
    sp, nbrs, _ = _jax_space(metric)
    store_sq = sp.metric == "l2"
    jc, jx = jbqg._encode_block(sp.data, sp.dmin, sp.scale,
                                jnp.asarray(nbrs), store_sq=store_sq)
    tc, tx = tbqg._encode_block(torch.from_numpy(np.array(sp.data)),
                                torch.from_numpy(np.array(sp.dmin)),
                                torch.from_numpy(np.array(sp.scale)),
                                torch.from_numpy(nbrs), store_sq=store_sq)
    jc, jx = np.asarray(jc), np.asarray(jx)
    assert tc.shape == jc.shape == (96, 8, 128)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert (jc[:, :, 40:] == 128).all()           # Dp pad is the centre byte
    assert np.isinf(jx[nbrs < 0]).all()
    np.testing.assert_array_equal(np.isinf(tx.numpy()), np.isinf(jx))
    fin = np.isfinite(jx)
    np.testing.assert_allclose(tx.numpy()[fin], jx[fin], rtol=1e-6)
    if not store_sq:
        assert (jx[fin] == 0).all() and (tx.numpy()[fin] == 0).all()


@pytest.mark.parametrize("metric", METRICS)
def test_fit_and_update_neighbors_match_jax(metric):
    sp, nbrs, rng = _jax_space(metric)
    data = rng.normal(size=(96, 40)).astype(np.float32)
    jsp = jbqg.BQGSpace.create(96, 40, metric=metric, degree=8).fit(data)
    jsp = jsp.update_neighbors(nbrs)
    tsp = tbqg.BQGSpace.create(96, 40, metric=metric, degree=8).fit(data)
    tsp.update_neighbors(nbrs, chunk=32)
    np.testing.assert_allclose(tsp.data.numpy(), np.asarray(jsp.data),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tsp.nbr_ids.numpy(), np.asarray(jsp.nbr_ids))
    # the grid comes from normalized data under cos: allow one code step
    diff = np.abs(tsp.nbr_codes.numpy().astype(int)
                  - np.asarray(jsp.nbr_codes).astype(int))
    assert diff.max() <= (1 if metric == "cos" else 0)


@pytest.mark.parametrize("metric", METRICS)
def test_query_ctx_and_estimate_many_match_jax(metric):
    sp, _, rng = _jax_space(metric, seed=1)
    tsp = tbqg.BQGSpace.load_arrays(sp.save_arrays())
    q = rng.normal(size=(6, 40)).astype(np.float32) * 3
    u = rng.integers(0, 96, size=(6, 4)).astype(np.int32)
    jctx = sp.query_ctx(sp.prep_query(jnp.asarray(q)))
    tctx = tsp.query_ctx(tsp.prep_query(torch.from_numpy(q)))
    np.testing.assert_array_equal(
        tctx[1].float().numpy(), np.asarray(jctx[1]).astype(np.float32))
    np.testing.assert_allclose(tctx[2].numpy(), np.asarray(jctx[2]),
                               rtol=1e-5, atol=1e-3)
    je, ji = sp.estimate_many(jctx, jnp.asarray(u))
    te, ti = tsp.estimate_many(tctx, torch.from_numpy(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-3)


def _tie_rows(seed):
    rng = np.random.default_rng(seed)
    B, L1, L2 = 5, 12, 20
    # few distinct distances: many ties within and across the operands
    d1 = np.sort(rng.integers(0, 6, size=(B, L1)).astype(np.float32), axis=1)
    d2 = rng.integers(0, 6, size=(B, L2)).astype(np.float32)
    i1 = rng.permutation(40)[:L1][None].repeat(B, 0).astype(np.int32)
    i2 = rng.integers(-1, 40, size=(B, L2)).astype(np.int32)
    d2[:, 5:10] = d2[:, 0:5]                      # duplicates: same (d, id)
    i2[:, 5:10] = i2[:, 0:5]
    d2[i2 < 0] = np.inf
    d1[:, -2:] = np.inf
    i1[:, -2:] = -1
    f1 = rng.random(size=(B, L1)) < 0.5
    f2 = np.zeros((B, L2), bool)
    return d1, i1, f1, d2, i2, f2


@pytest.mark.parametrize("fn", ["merge_topk_with_flags", "merge_topk_dedup"])
@pytest.mark.parametrize("seed", [0, 1])
def test_merges_match_jax(fn, seed):
    args = _tie_rows(seed)
    jd, ji, jf = getattr(jtopk, fn)(*map(jnp.asarray, args), 16)
    td, ti, tf = getattr(ttopk, fn)(*map(torch.from_numpy, args), 16)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_merge_topk_matches_jax():
    d1, i1, _, d2, i2, _ = _tie_rows(2)
    jd, ji = jtopk.merge_topk(*map(jnp.asarray, (d1, i1, d2, i2)), 10)
    td, ti = ttopk.merge_topk(*map(torch.from_numpy, (d1, i1, d2, i2)), 10)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("m", [1, 3, 8])
def test_pop_best_m_matches_jax(m):
    d1, i1, f1, _, _, _ = _tie_rows(3)
    ju, ja, jc = jsearch._pop_best_m(*map(jnp.asarray, (d1, i1, f1)), m)
    tu, ta, tc = tsearch._pop_best_m(*map(torch.from_numpy, (d1, i1, f1)), m)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
