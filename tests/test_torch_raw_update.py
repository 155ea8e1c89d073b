"""Mutation of raw graph indices in the port (insert through the search, the
append, ``fused_raw_connect`` and the overlay link; the bsq8 insert
shadow; remove, compact, update_nodes) and integer / float16 storage,
against the JAX package at small size on the CPU.

Module level: ``strip_overlay``, ``draw_levels``, the overlay link, the
connect step, the shadow's block re-encode, the rewire at fusion width and
the storage casts take the same numpy inputs as their JAX counterparts
(the connect step takes JAX's own reservoir slots) and must give the same
state; where f32 sums in another order may break a near-tie the other way,
at least 99% of the written rows must agree and every differing row must
hold such a tie. Slice level: the raw cases of the JAX package's
maintenance, update and insert-path tests, run on the port with their
floors. ``tests/test_torch_raw_cross.py`` loads mutated indices both ways.
"""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.index import engine as engine_mod
from alayalite_tpu_torch.index.engine import _rewire_rows_dev
from alayalite_tpu_torch.index.fused_insert import fused_raw_connect
from alayalite_tpu_torch.index.graph import Graph, OverlayLevel
from alayalite_tpu_torch.index.overlay_update import (draw_levels,
                                                      link_overlay,
                                                      strip_overlay)
from alayalite_tpu_torch.spaces.bqg import shadow_blocks_update, shadow_space
from alayalite_tpu_torch.spaces.raw import RawSpace
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall

# the tensors here are small: more threads only contend with the other
# test workers'
torch.set_num_threads(2)

N, DIM = 1200, 16


def _clustered(rng, n, dim, clusters=12):
    centers = rng.normal(size=(clusters, dim)) * 3.0
    return (centers[rng.integers(0, clusters, size=n)]
            + rng.normal(size=(n, dim))).astype(np.float32)


def _spaces(data, capacity, metric="l2", fit=None):
    """The same RawSpace in both packages, ``fit`` rows fitted and the rest
    of ``data`` appended by ``insert``."""
    import jax.numpy as jnp

    from alayalite_tpu.spaces.raw import RawSpace as JaxRaw

    fit = data.shape[0] if fit is None else fit
    jsp = JaxRaw.create(capacity, data.shape[1], metric=metric).fit(
        jnp.asarray(data[:fit]))
    sp = RawSpace.create(capacity, data.shape[1], metric=metric).fit(
        torch.from_numpy(data[:fit]))
    jids = ids = None
    if fit < data.shape[0]:
        jsp, jids = jsp.insert(jnp.asarray(data[fit:]))
        ids = sp.insert(torch.from_numpy(data[fit:]))
        np.testing.assert_array_equal(np.asarray(jids), ids.numpy())
    return jsp, sp, ids


def _knn(x, y, k, skip_self=False):
    d = ((x[:, None, :].astype(np.float64) - y[None]) ** 2).sum(-1)
    if skip_self:
        np.fill_diagonal(d, np.inf)
    return np.argsort(d, axis=1, kind="stable")[:, :k].astype(np.int32)


# ---------------------------------------------------------------- overlay
def _overlay(rng, data, r2, sizes, pads):
    """Levels (top first) over the rows of ``data``: member ids, exact kNN
    rows in local slots, ``down`` chains, then ``pads`` free slots each."""
    members, cur = [], np.arange(data.shape[0])
    for s in sizes[::-1]:
        cur = np.sort(rng.choice(cur, size=s, replace=False))
        members.append(cur)
    members = members[::-1]
    levels = []
    for li, (m, p) in enumerate(zip(members, pads)):
        nbrs = np.full((m.size + p, r2), -1, np.int32)
        k = min(r2, m.size - 1)
        nbrs[:m.size, :k] = _knn(data[m], data[m], k, skip_self=True)
        down = (np.searchsorted(members[li + 1], m)
                if li + 1 < len(members) else m)
        levels.append((np.concatenate([m, np.full(p, -1)]).astype(np.int32),
                       nbrs,
                       np.concatenate([down, np.full(p, -1)]).astype(
                           np.int32)))
    return levels


def _jax_levels(levels):
    import jax.numpy as jnp

    from alayalite_tpu.index.graph import OverlayLevel as JaxLevel

    return tuple(JaxLevel(ids=jnp.asarray(i), nbrs=jnp.asarray(nb, jnp.int32),
                          down=jnp.asarray(d)) for i, nb, d in levels)


def _port_levels(levels):
    return tuple(OverlayLevel(ids=torch.tensor(i),
                              nbrs=torch.tensor(nb.astype(np.int32)),
                              down=torch.tensor(d)) for i, nb, d in levels)


def test_strip_overlay_matches_jax():
    """Removed ids leave every level: their slots become −1, local edges to
    them −1, ``down`` stays; equal arrays to the JAX package's."""
    from alayalite_tpu.index.graph import Graph as JaxGraph
    from alayalite_tpu.index.overlay_update import strip_overlay as jax_strip

    rng = np.random.default_rng(3)
    data = _clustered(rng, 500, 16)
    levels = _overlay(rng, data, 4, (8, 40), (4, 12))
    removed = np.concatenate([levels[0][0][:3], levels[1][0][5:20:2],
                              [7, 499]]).astype(np.int32)
    jg = jax_strip(JaxGraph(nbrs=None, eps=None, overlay=_jax_levels(levels)),
                   removed)
    g = Graph(nbrs=torch.zeros((1, 1), dtype=torch.int32),
              eps=torch.zeros(1, dtype=torch.int32),
              overlay=_port_levels(levels))
    strip_overlay(g, removed)
    for jl, lvl, (ids0, _, down0) in zip(jg.overlay, g.overlay, levels):
        np.testing.assert_array_equal(np.asarray(jl.ids), lvl.ids.numpy())
        np.testing.assert_array_equal(np.asarray(jl.nbrs), lvl.nbrs.numpy())
        np.testing.assert_array_equal(np.asarray(jl.down), lvl.down.numpy())
        np.testing.assert_array_equal(lvl.down.numpy(), down0)
        assert not np.isin(lvl.ids.numpy(), removed).any()
    for lvl, (ids0, _, _), pad in zip(g.overlay, levels, (4, 12)):
        assert (lvl.ids.numpy() == -1).sum() == pad + np.isin(
            ids0, removed).sum() > pad


def test_draw_levels_matches_jax():
    from alayalite_tpu.index.overlay_update import draw_levels as jax_draw

    for seed, r, depth in ((0, 16, 8), (0xA1A7A, 32, 3), (5, 8, 1)):
        a = jax_draw(np.random.default_rng(seed), 20_000, r, depth)
        b = draw_levels(np.random.default_rng(seed), 20_000, r, depth)
        np.testing.assert_array_equal(a, b)
    lv = draw_levels(np.random.default_rng(0), 200_000, r=16, max_level=8)
    assert abs(float((lv >= 1).mean()) - 1 / 16) < 0.005


def _same_rows_share(got, want, before):
    """(share of written rows equal, indices of the differing rows): a row
    is written where either result differs from ``before``."""
    written = np.flatnonzero((got != before).any(1) | (want != before).any(1))
    differ = written[(got[written] != want[written]).any(1)]
    return 1.0 - differ.size / max(written.size, 1), differ, written


@pytest.mark.parametrize("metric,pads", [("l2", (6, 30)), ("ip", (6, 30)),
                                         ("l2", (40, 5))])
def test_link_overlay_matches_jax_device_edition(metric, pads):
    """The overlay link against ``_extend_overlay_dev`` on the same levels,
    rows and draws: half the new nodes crowd one spot, so many pairs hit
    the same rows and the sequential patch decides; slots freed by a strip
    are reused; with pads (40, 5) the bottom level overflows. Level ids
    and down equal; level rows equal on ≥ 99% of the written rows."""
    import jax.numpy as jnp

    from alayalite_tpu.index.overlay_update import _extend_overlay_dev

    rng = np.random.default_rng(11)
    n, M, r2 = 600, 48, 4
    base = _clustered(rng, n, 16)
    new = np.concatenate([base[:M // 2] * 0.0 + base[3]
                          + 0.3 * rng.normal(size=(M // 2, 16)),
                          _clustered(rng, M - M // 2, 16)]).astype(np.float32)
    data = np.concatenate([base, new])
    jsp, sp, ids = _spaces(data, n + M, metric=metric, fit=n)
    levels = _overlay(rng, base, r2, (10, 60), pads)
    removed = levels[1][0][np.arange(2, 40, 4)]
    for li in (0, 1):                  # strip by hand: free slots mid-level
        dead = np.isin(levels[li][0], removed)
        levels[li][1][np.isin(levels[li][1], np.flatnonzero(dead))] = -1
        levels[li][0][dead] = -1
    up = ids.numpy()
    lv = rng.integers(1, 3, size=M).astype(np.int32)
    mcap = -(-M // 32) * 32
    want = _extend_overlay_dev(
        _jax_levels(levels), jsp,
        jnp.asarray(np.pad(up, (0, mcap - M), constant_values=-1)),
        jnp.asarray(np.pad(lv, (0, mcap - M))))
    got = _port_levels(levels)
    link_overlay(got, sp, torch.from_numpy(up), torch.from_numpy(lv))
    for li, (jl, lvl) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(jl.ids), lvl.ids.numpy())
        np.testing.assert_array_equal(np.asarray(jl.down), lvl.down.numpy())
        share, _, written = _same_rows_share(lvl.nbrs.numpy(),
                                             np.asarray(jl.nbrs),
                                             levels[li][1])
        assert written.size > 0 and share >= 0.99, (li, share)
    placed = (got[1].ids.numpy()[:, None] == up[None]).any(0)
    if pads[1] < 30:
        assert placed.sum() < (lv >= 1).sum()          # the overflow drops
    # invariants: edges point at occupied slots, down chains resolve
    for li, lvl in enumerate(got):
        i, nb, dn = lvl.ids.numpy(), lvl.nbrs.numpy(), lvl.down.numpy()
        occ = np.flatnonzero(i >= 0)
        t = nb[occ]
        assert (i[t[t >= 0]] >= 0).all()
        if li == 0:
            new_top = occ[np.isin(i[occ], up)]
            assert (got[1].ids.numpy()[dn[new_top]] == i[new_top]).all()


# ------------------------------------------------------------ connect step
def _near_tie(data, t, a_ids, b_ids, cands, rel=1e-4):
    """Every id in one row and not the other holds a near-tie: its bf16
    distance to row ``t`` agrees within ``rel`` with another candidate's,
    or with some candidate's distance to it (the occlusion test)."""
    x = data.astype(np.float32)
    xb = torch.tensor(x).to(torch.bfloat16).double().numpy()
    cands = np.unique(cands[cands >= 0])
    dt = ((xb[cands] - xb[t]) ** 2).sum(1)
    for j in set(a_ids[a_ids >= 0]) ^ set(b_ids[b_ids >= 0]):
        dj = ((xb[j] - xb[t]) ** 2).sum()
        others = dt[cands != j]
        pair = ((xb[cands] - xb[j]) ** 2).sum(1)[cands != j]
        tol = rel * max(abs(dj), 1e-12)
        if not (np.abs(others - dj) <= tol).any() and not (
                np.abs(pair - dj) <= tol).any():
            return False
    return True


@pytest.mark.parametrize("row_w,metric", [(32, "l2"), (64, "l2"),
                                          (32, "ip")])
def test_fused_raw_connect_matches_jax(row_w, metric):
    """``fused_raw_connect`` on the same adjacency, appended rows, searched
    edges and JAX's own reservoir slots: hnsw rows (row_w 32: candidates
    48 wide) and fusion rows (64: 80 wide). ≥ 99% of the written rows
    equal, and every differing row holds a near-tie (relative 1e-4)."""
    import jax
    import jax.numpy as jnp

    from alayalite_tpu.index.fused_insert import \
        fused_raw_connect as jax_connect

    rng = np.random.default_rng(row_w + (metric == "ip"))
    n, B, r = 700, 64, 32
    base = _clustered(rng, n, 24)
    new = np.concatenate([_clustered(rng, B // 2, 24),
                          base[:B // 2] + 0.05 * rng.normal(size=(B // 2, 24))
                          ]).astype(np.float32)
    cap = n + B - 4                              # the last 4 rows do not fit
    jsp, sp, ids = _spaces(np.concatenate([base, new]), cap, metric=metric,
                           fit=n)
    nbrs = np.full((cap, row_w), -1, np.int32)
    nbrs[:n] = _knn(base, base, row_w, skip_self=True)
    nbrs[:n][rng.random((n, row_w)) < 0.15] = -1
    nrow = _knn(new, base, r)
    nrow[rng.random((B, r)) < 0.05] = -1
    nid = ids.numpy()
    nrow[nid < 0] = -1
    key = jax.random.PRNGKey(7)
    slots = np.array(jax.random.randint(key, (B, row_w), 0, 16))
    want, jt = jax_connect(jsp, jnp.asarray(nbrs), jnp.asarray(nid),
                           jnp.asarray(nrow), key, row_w=row_w,
                           chunk=min(8192, B * row_w))
    want, jt = np.asarray(want), np.asarray(jt)
    g = torch.from_numpy(nbrs.copy())
    touched = fused_raw_connect(sp, g, ids, torch.from_numpy(nrow),
                                torch.from_numpy(slots), row_w=row_w,
                                chunk=1000)
    np.testing.assert_array_equal(touched.numpy(), jt)
    got = g.numpy()
    share, differ, written = _same_rows_share(got, want, nbrs)
    assert written.size > B and share >= 0.99, share
    data = np.concatenate([base, new])
    for t in differ:
        cands = np.concatenate([nbrs[t], got[t], want[t], nid])
        assert _near_tie(data, t, got[t], want[t], cands), t
    assert (got[nid[nid >= 0]] >= 0).any(1).all()


def test_shadow_blocks_update_matches_jax():
    """The shadow over a raw slab and its re-encode of new and touched rows
    (repeats and −1 in the list) against the JAX package's: codes byte for
    byte, ids equal, |x̂|² within 1e-5 relative."""
    import jax.numpy as jnp

    from alayalite_tpu.spaces.bqg import BQGSpace as JaxBQG
    from alayalite_tpu.spaces.bqg import shadow_blocks_update as jax_update

    rng = np.random.default_rng(4)
    n, w, dim = 500, 24, 40
    data = _clustered(rng, n + 40, dim)
    jsp_raw, sp_raw, _ = _spaces(data, n + 60, fit=n)
    nbrs = rng.integers(-1, n + 40, size=(n + 60, w)).astype(np.int32)
    nbrs[n + 40:] = -1
    jsh = JaxBQG.create(n + 60, dim, metric="l2", degree=w)
    live = jsp_raw.data[:n]
    dmin = jnp.min(live, axis=0)
    scale = jnp.maximum((jnp.max(live, axis=0) - dmin) / 255.0, 1e-30)
    jsh = jsh.replace(data=jsp_raw.data, sq_norms=jsp_raw.sq_norms, dmin=dmin,
                      scale=scale, valid=jsp_raw.valid,
                      num=jnp.asarray(n, jnp.int32))
    jsh = jsh.update_neighbors(jnp.asarray(nbrs))
    sp_raw.num = n                  # the shadow is packed before the append
    sh = shadow_space(sp_raw.data, sp_raw.sq_norms, sp_raw.valid, n, "l2",
                      torch.from_numpy(nbrs))
    np.testing.assert_array_equal(np.asarray(jsh.nbr_codes),
                                  sh.nbr_codes.numpy())
    nbrs2 = nbrs.copy()
    upd = rng.integers(0, n + 40, size=300).astype(np.int32)
    nbrs2[upd] = rng.integers(-1, n + 40, size=(300, w))
    upd = np.concatenate([upd, upd[:50], [-1, -1, -1]]).astype(np.int32)
    chunk = 256
    pad = -(-upd.size // chunk) * chunk - upd.size
    ni, nc, nx = jax_update(jsh.nbr_ids, jsh.nbr_codes, jsh.nbr_xsq,
                            jsp_raw.data, jsh.dmin, jsh.scale,
                            jnp.asarray(nbrs2),
                            jnp.asarray(np.pad(upd, (0, pad),
                                               constant_values=-1)),
                            chunk=chunk)
    shadow_blocks_update(sh, torch.from_numpy(nbrs2), torch.from_numpy(upd))
    np.testing.assert_array_equal(np.asarray(ni), sh.nbr_ids.numpy())
    np.testing.assert_array_equal(np.asarray(nc), sh.nbr_codes.numpy())
    np.testing.assert_allclose(np.asarray(nx), sh.nbr_xsq.numpy(), rtol=1e-5)
    assert sh.data is sp_raw.data and sh.valid is sp_raw.valid


def test_rewire_rows_at_fusion_width_match_jax():
    """``_rewire_rows_dev`` at the fusion row width (2·max_nbrs = 24): the
    same rows as JAX's, as sets, with the same distances (rtol 1e-5)."""
    import jax.numpy as jnp

    from alayalite_tpu.index.engine import _rewire_rows_dev as jax_rewire

    rng = np.random.default_rng(9)
    n, w = 800, 24
    data = _clustered(rng, n, 16)
    jsp, sp, _ = _spaces(data, n)
    nbrs = _knn(data, data, w, skip_self=True)
    nbrs[rng.random((n, w)) < 0.2] = -1
    removed = np.arange(0, n, 6)
    mask = np.zeros(n, bool)
    mask[removed] = True
    ids = np.flatnonzero(np.isin(nbrs, removed).any(1) & ~mask)
    ids = ids.astype(np.int32)
    want = np.asarray(jax_rewire(jsp, jnp.asarray(nbrs), jnp.asarray(mask),
                                 jnp.asarray(ids), r=w))
    got = _rewire_rows_dev(sp, torch.from_numpy(nbrs), torch.from_numpy(mask),
                           torch.from_numpy(ids).long(), r=w).numpy()
    assert got.shape == want.shape == (ids.size, w)
    assert not np.isin(got, removed).any()
    same = sum(set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(got, want))
    assert same >= 0.99 * ids.size
    assert (got == want).all(1).mean() >= 0.99


@pytest.mark.parametrize("dtype", ["uint8", "int8", "float16"])
def test_storage_casts_match_jax(dtype):
    """fit and insert into uint8 / int8 / float16 rows: the stored rows
    (out-of-range and NaN inputs included: saturating casts, NaN to 0),
    the norms from the f32 input (rtol 1e-6: sums in another order) and
    the distances equal the JAX package's; a save/load round trip keeps
    the rows."""
    import jax.numpy as jnp

    from alayalite_tpu.spaces.raw import RawSpace as JaxRaw

    rng = np.random.default_rng(2)
    x = (rng.normal(size=(60, 16)) * 100).astype(np.float32)
    x[0, :4] = [np.nan, np.inf, -np.inf, 300.7]
    j = JaxRaw.create(80, 16, storage_dtype=dtype).fit(jnp.asarray(x[:50]))
    j, jids = j.insert(jnp.asarray(x[50:]))
    p = RawSpace.create(80, 16, storage_dtype=dtype).fit(
        torch.from_numpy(x[:50]))
    ids = p.insert(torch.from_numpy(x[50:]))
    np.testing.assert_array_equal(np.asarray(jids), ids.numpy())
    np.testing.assert_array_equal(np.asarray(j.data.astype(jnp.float32)),
                                  p.data.float().numpy())
    np.testing.assert_allclose(np.asarray(j.sq_norms), p.sq_norms.numpy(),
                               rtol=1e-6)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    cand = rng.integers(1, 60, size=(5, 9)).astype(np.int32)
    np.testing.assert_allclose(
        np.asarray(j.gather_dists(jnp.asarray(q), jnp.asarray(cand))),
        p.gather_dists(torch.from_numpy(q), torch.from_numpy(cand)).numpy(),
        rtol=1e-5)
    back = RawSpace.load_arrays(j.save_arrays(), storage_dtype=dtype)
    assert back.data.dtype == p.data.dtype
    np.testing.assert_array_equal(back.data.float().numpy(),
                                  p.data.float().numpy())


# ------------------------------------------------------------ slice level
def _raw(kind="hnsw", capacity=N + 512, **kw):
    kw.setdefault("max_nbrs", 8)
    kw.setdefault("ef_construction", 64)
    return IndexParams(index_type=kind, capacity=capacity, **kw)


def test_insert_extends_overlay():
    """tests/test_maintenance.py: inserts extend the padded overlay levels;
    edges point at occupied slots, down chains resolve; new rows found."""
    ds = random_dataset(n=N, dim=DIM, n_queries=8, seed=5)
    idx = Index("t", _raw(), device="cpu")
    idx.fit(ds.data)
    eng = idx._engine
    occ0 = [int((lvl.ids >= 0).sum()) for lvl in eng.graph.overlay]
    rng = np.random.default_rng(11)
    new = (ds.data[rng.integers(0, N, size=256)]
           + 0.05 * rng.normal(size=(256, DIM)).astype(np.float32))
    new_ids = idx.insert(new)
    assert (new_ids == np.arange(N, N + 256)).all()
    occ1 = [int((lvl.ids >= 0).sum()) for lvl in eng.graph.overlay]
    assert occ1[-1] > occ0[-1], (occ0, occ1)
    for li, lvl in enumerate(eng.graph.overlay):
        ids, nbrs, down = (lvl.ids.numpy(), lvl.nbrs.numpy(),
                           lvl.down.numpy())
        occ = np.flatnonzero(ids >= 0)
        tgt = nbrs[occ]
        assert (ids[tgt[tgt >= 0]] >= 0).all(), li
        if li + 1 < len(eng.graph.overlay):
            below = eng.graph.overlay[li + 1].ids.numpy()
            assert (below[down[occ]] == ids[occ]).all(), li
        else:
            assert (down[occ] == ids[occ]).all()
    ids = idx.batch_search(new[:16], 5, ef_search=64)
    assert np.mean([new_ids[i] in ids[i] for i in range(16)]) >= 0.9


def test_overlay_full_level_degrades_gracefully():
    """Every insert draws the top level while the bottom level has little
    room: truncated nodes stay on the levels they reached."""
    n = 600
    ds = random_dataset(n=n, dim=DIM, n_queries=4, seed=21)
    idx = Index("full", _raw(capacity=n + 40, ef_construction=48),
                device="cpu")
    idx.fit(ds.data)
    eng = idx._engine
    assert len(eng.graph.overlay) >= 2

    class _MaxLevelRng:
        def uniform(self, low=0.0, size=None):
            return np.full(size, 1e-12)

    eng._rng = _MaxLevelRng()
    rng = np.random.default_rng(3)
    new = (ds.data[rng.integers(0, n, size=32)]
           + 0.05 * rng.normal(size=(32, DIM)).astype(np.float32))
    new_ids = idx.insert(new)
    for li, lvl in enumerate(eng.graph.overlay):
        ids, down = lvl.ids.numpy(), lvl.down.numpy()
        occ = np.flatnonzero(ids >= 0)
        if li + 1 < len(eng.graph.overlay):
            below = eng.graph.overlay[li + 1].ids.numpy()
            assert (below[down[occ]] == ids[occ]).all(), li
        else:
            assert (down[occ] == ids[occ]).all()
    ids = idx.batch_search(new[:8], 5, ef_search=64)
    assert np.mean([new_ids[i] in ids[i] for i in range(8)]) >= 0.8


def test_outlier_batch_insert_reachable():
    """A co-located batch of outliers stays reachable after one insert:
    the searched edges anchor it, the batch mates link it."""
    ds = random_dataset(n=N, dim=DIM, n_queries=4, seed=13)
    idx = Index("o", _raw(capacity=N + 64, max_nbrs=16), device="cpu")
    idx.fit(ds.data)
    rng = np.random.default_rng(7)
    out = (20.0 + 0.5 * rng.normal(size=(40, DIM))).astype(np.float32)
    new_ids = np.asarray(idx.insert(out))
    q = (out[:16] + 0.05 * rng.normal(size=(16, DIM))).astype(np.float32)
    all_data = np.concatenate([ds.data, out])
    all_ids = np.concatenate([np.arange(N), new_ids]).astype(np.int64)
    d2 = ((q[:, None] - all_data[None]) ** 2).sum(-1)
    gt = all_ids[np.argsort(d2, axis=1)[:, :10]]
    rec = calc_recall(idx.batch_search(q, 10, ef_search=96), gt)
    assert rec >= 0.8, rec


@pytest.mark.parametrize("kind", ["hnsw", "nsg", "fusion"])
def test_update_nodes_rewires_through_removed(kind):
    """Manual compaction: no removed id left in a live row, none in an
    overlay level, every entry point live, recall ≥ 0.8."""
    ds = random_dataset(n=N, dim=DIM, n_queries=16, seed=6)
    idx = Index("u", _raw(kind, capacity=N, max_nbrs=16,
                          compaction_threshold=0.0), device="cpu")
    idx.fit(ds.data)
    eng = idx._engine
    removed = np.arange(0, N, 5, dtype=np.int32)
    if kind == "hnsw":
        removed = np.union1d(removed, eng.graph.eps.numpy()[:1])
    idx.remove(removed)
    assert len(eng._removed) == removed.size
    before = eng.graph.nbrs.numpy().copy()
    eng.compact()
    after = eng.graph.nbrs.numpy()
    assert eng._removed == []
    live = np.setdiff1d(np.arange(N), removed)
    assert not np.isin(after[live], removed).any()
    assert (after[removed] == before[removed]).all()   # tombstones untouched
    assert after.shape[1] == (32 if kind == "fusion" else 16)
    for lvl in eng.graph.overlay:
        assert not np.isin(lvl.ids.numpy(), removed).any()
    assert not np.isin(eng.graph.eps.numpy(), removed).any()
    gt = calc_gt(ds.data, ds.queries, 10, deleted=removed, device="cpu")
    assert calc_recall(idx.batch_search(ds.queries, 10, ef_search=80),
                       gt) >= 0.8
    eng.update_nodes(live[:50])                        # no removed set
    assert calc_recall(idx.batch_search(ds.queries, 10, ef_search=80),
                       gt) >= 0.8


def _churn(index_cls, params_cls, ds, n, **kw):
    """tests/test_maintenance.py's 30% churn on raw hnsw."""
    idx = index_cls("c", params_cls(index_type="hnsw", capacity=3 * n,
                                    max_nbrs=16, ef_construction=64,
                                    compaction_threshold=0.15), **kw)
    idx.fit(ds.data)
    rng = np.random.default_rng(1)
    vecs = {i: ds.data[i] for i in range(n)}
    live = set(range(n))
    for _ in range(3):
        doomed = rng.choice(sorted(live), size=n // 10, replace=False)
        idx.remove(doomed.astype(np.int32))
        live -= set(int(x) for x in doomed)
        fresh = rng.normal(size=(n // 10, DIM)).astype(np.float32)
        new_ids = np.asarray(idx.insert(fresh))
        assert (new_ids >= 0).all()
        for j, nid in enumerate(new_ids):
            vecs[int(nid)] = fresh[j]
            live.add(int(nid))
    live_ids = np.asarray(sorted(live), dtype=np.int64)
    base = np.stack([vecs[int(i)] for i in live_ids])
    d2 = ((ds.queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt = live_ids[np.argsort(d2, axis=1)[:, :10]]
    ids = np.asarray(idx.batch_search(ds.queries, 10, ef_search=96))
    dead = np.setdiff1d(np.arange(idx._engine.num), live_ids)
    assert not np.isin(ids[ids >= 0], dead).any()
    return calc_recall(ids, gt), idx


def test_churn_30pct_holds_recall():
    n = 900
    ds = random_dataset(n=n, dim=DIM, n_queries=16, seed=9)
    rec, _ = _churn(Index, IndexParams, ds, n, device="cpu")
    assert rec >= 0.8, f"churn recall {rec}"


def _shadow_run(monkeypatch, on: bool):
    """tests/test_insert_paths.py's shadow fixture, on the port: three
    batches of perturbed copies into raw hnsw, with the shadow's size gate
    at 0 (on) or past the index (off)."""
    monkeypatch.setattr(engine_mod, "SHADOW_MIN_ROWS", 0 if on else 10**9)
    ds = random_dataset(n=N, dim=32, n_queries=64, seed=9)
    idx = Index("s", IndexParams(index_type="hnsw", capacity=2048,
                                 max_nbrs=16, ef_construction=64),
                device="cpu")
    idx.fit(ds.data)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        b = (ds.data[rng.integers(0, N, size=200)]
             + 0.05 * rng.normal(size=(200, 32))).astype(np.float32)
        batches.append((idx.insert(b), b))
    return idx, ds, batches


@pytest.mark.parametrize("on", [True, False])
def test_insert_shadow_quality(monkeypatch, on):
    """Own hit ≥ 0.95 per batch and recall ≥ 0.90 over every stored row,
    with the shadow and without it; the shadow's blocks stay in step with
    the adjacency and its slab is the raw space's own."""
    idx, ds, batches = _shadow_run(monkeypatch, on)
    eng = idx._engine
    assert (eng._ins_shadow is not None) == on
    for new_ids, b in batches:
        got = idx.batch_search(b[:64], 10, ef_search=96)
        assert np.mean([new_ids[i] in got[i] for i in range(64)]) >= 0.95
    full = np.concatenate([ds.data] + [b for _, b in batches])
    gt = calc_gt(full, ds.queries, 10, device="cpu")
    assert calc_recall(idx.batch_search(ds.queries, 10, ef_search=96),
                       gt) >= 0.90
    if on:
        sh = eng._ins_shadow
        assert sh.data is eng.space.data and sh.num == eng.num
        assert torch.equal(sh.nbr_ids[:eng.num], eng.graph.nbrs[:eng.num])
        from alayalite_tpu_torch.spaces.bqg import _encode_block

        codes, _ = _encode_block(sh.data, sh.dmin, sh.scale,
                                 sh.nbr_ids[:eng.num])
        assert torch.equal(codes, sh.nbr_codes[:eng.num])


def test_insert_shadow_dropped_by_mutations(monkeypatch):
    idx, ds, batches = _shadow_run(monkeypatch, True)
    eng = idx._engine
    assert eng._ins_shadow is not None
    idx.remove(int(batches[0][0][0]))
    assert eng._ins_shadow is None            # its valid mask would be stale
    nid = idx.insert(ds.data[:4] + 0.01)      # repacks, still works
    assert (nid >= 0).all() and eng._ins_shadow is not None
    eng.update_nodes([1, 2])
    assert eng._ins_shadow is None
    idx.insert(ds.data[4:6] + 0.01)
    assert eng._ins_shadow is not None
    eng.compact()
    assert eng._ins_shadow is None
    # a storage dtype other than f32 never packs one
    monkeypatch.setattr(engine_mod, "SHADOW_MIN_ROWS", 0)
    b = Index("b", IndexParams(index_type="hnsw", capacity=700, max_nbrs=8,
                               storage_dtype="bfloat16"), device="cpu")
    b.fit(ds.data[:600])
    b.insert(ds.data[600:610])
    assert b._engine._ins_shadow is None


def test_insert_capacity_error():
    ds = random_dataset(n=300, dim=DIM, n_queries=1, seed=1)
    idx = Index("cap", _raw(capacity=310), device="cpu")
    idx.fit(ds.data)
    eng = idx._engine
    far = np.full((16, DIM), 30.0, np.float32) + np.arange(16)[:, None]
    ids = eng.insert(far)
    assert (ids[:10] == np.arange(300, 310)).all() and (ids[10:] == -1).all()
    assert eng.num == 310
    assert (eng.graph.nbrs[300:310] >= 0).any(1).all()
    with pytest.raises(RuntimeError, match="full"):
        idx.insert(ds.data[0])


def test_fusion_insert_after_fit():
    """Fusion rows are 2·max_nbrs wide; an insert pads its r-wide rows."""
    ds = random_dataset(n=300, dim=DIM, n_queries=4, seed=11)
    idx = Index("f", _raw("fusion", capacity=360, max_nbrs=12,
                          ef_construction=48), device="cpu")
    idx.fit(ds.data)
    rng = np.random.default_rng(1)
    new = ds.data[:8] + 0.01 * rng.normal(size=(8, DIM)).astype(np.float32)
    new_ids = idx.insert(new)
    assert (new_ids >= 300).all()
    assert idx._engine.graph.nbrs.shape[1] == 24
    ids = idx.batch_search(new, 5, ef_search=48)
    assert np.mean([new_ids[i] in ids[i] for i in range(8)]) >= 0.9


@pytest.mark.parametrize("quant", ["sq8", "sq4"])
def test_sq_insert_then_remove(quant):
    ds = random_dataset(n=900, dim=DIM, n_queries=16, seed=3)
    idx = Index("q", _raw(capacity=1000, max_nbrs=16,
                          quantization_type=quant), device="cpu")
    idx.fit(ds.data)
    rng = np.random.default_rng(0)
    new = ds.data[:16] + 0.01 * rng.normal(size=(16, DIM)).astype(np.float32)
    new_ids = idx.insert(new)
    eng = idx._engine
    assert eng.search_space.num == eng.space.num == 916
    ids = idx.batch_search(new, 5, ef_search=64)
    assert np.mean([new_ids[i] in ids[i] for i in range(16)]) >= 0.9
    dead = np.concatenate([np.arange(0, 900, 3), new_ids[:4]])
    idx.remove(dead)
    assert not eng.search_space.valid[torch.from_numpy(dead)].any()
    eng.compact()
    ids = idx.batch_search(ds.queries, 10, ef_search=80)
    assert not np.isin(ids[ids >= 0], dead).any()
    gt = calc_gt(np.concatenate([ds.data, new]), ds.queries, 10,
                 deleted=dead, device="cpu")
    assert calc_recall(ids, gt) >= 0.8


@pytest.mark.parametrize("dtype", ["uint8", "int8", "float16"])
def test_integer_and_float16_storage(dtype, tmp_path):
    """fit, search, insert, remove and save/load with rows stored as
    uint8 / int8 / float16 (integer data: ``data_type`` stores natively)."""
    rng = np.random.default_rng(8)
    lo = 0 if dtype == "uint8" else -60
    data = rng.integers(lo, lo + 120, size=(700, DIM)).astype(np.float32)
    if dtype == "float16":
        data = data / 7.0
    kw = (dict(storage_dtype=dtype) if dtype == "float16"
          else dict(data_type=dtype))
    idx = Index("d", _raw(capacity=800, max_nbrs=16, **kw), device="cpu")
    assert idx.params.storage_dtype == dtype
    idx.fit(data[:600])
    assert idx._engine.space.data.dtype == getattr(torch, dtype)
    new_ids = idx.insert(data[600:])
    assert (new_ids == np.arange(600, 700)).all()
    q = data[::7] + 0.1
    gt = calc_gt(data, q, 10, device="cpu")
    ids = idx.batch_search(q, 10, ef_search=64)
    assert calc_recall(ids, gt) >= 0.9
    idx.save(str(tmp_path / "d"))
    back = Index.load(str(tmp_path), "d", device="cpu")
    assert back._engine.space.data.dtype == getattr(torch, dtype)
    again = back.batch_search(q, 10, ef_search=64)
    if dtype == "float16":
        # a loaded index takes |x|² from the rounded rows (as the JAX
        # package does), the fitted one from the f32 input
        assert abs(calc_recall(again, gt) - calc_recall(ids, gt)) <= 0.01
    else:
        np.testing.assert_array_equal(again, ids)
    idx.remove(np.arange(0, 700, 4))
    ids = idx.batch_search(q, 10, ef_search=64)
    assert not np.isin(ids[ids >= 0], np.arange(0, 700, 4)).any()
    flat = Index("f", IndexParams(index_type="flat", capacity=800, **kw),
                 device="cpu")
    flat.fit(data)
    assert calc_recall(flat.batch_search(q, 10), gt) >= 0.999


# --------------------------------------------------------------- the card
@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_cuda_churn_agrees_with_cpu():
    """The same small churn on the card and on the CPU: recall within 0.01."""
    n = 900
    ds = random_dataset(n=n, dim=DIM, n_queries=16, seed=9)
    rec_c, _ = _churn(Index, IndexParams, ds, n, device="cpu")
    rec_g, idx = _churn(Index, IndexParams, ds, n, device="cuda")
    assert idx._engine.graph.nbrs.is_cuda
    assert abs(rec_g - rec_c) <= 0.01, (rec_g, rec_c)


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_cuda_shadow_insert_launches_gather_estimate(monkeypatch):
    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate

    monkeypatch.setattr(engine_mod, "SHADOW_MIN_ROWS", 0)
    ds = random_dataset(n=N, dim=32, n_queries=16, seed=9)
    idx = Index("g", IndexParams(index_type="hnsw", capacity=2048,
                                 max_nbrs=16, ef_construction=64))
    idx.fit(ds.data)
    gather_estimate.launches = 0
    new = ds.data[:256] + 0.05
    new_ids = idx.insert(new)
    assert gather_estimate.launches > 0
    assert idx._engine._ins_shadow is not None
    got = idx.batch_search(new[:64], 10, ef_search=96)
    assert np.mean([new_ids[i] in got[i] for i in range(64)]) >= 0.95
