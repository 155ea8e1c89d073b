"""The build's prune phases and the online inserts, fixed in shape.

On the CPU: each build phase of the port (``prune_all_dev`` at alpha 1.0
and 1.2, ``reprune_with_reverse_dev``, ``fill_degree_dev``,
``twohop_pool_dev``) is held to the JAX package's function on the same
candidates, ids equal: the rows are quarter-integers, so every bf16
product and f32 sum is exact and no tie breaks another way. The chunk
runner's row-id input gives the rows the Python offset gave, the
overlapping tail chunk included. A bsq8 and a raw insert padded to the
JAX engine's buckets write the same state as unpadded calls on the same
rows and the same reverse-table slots, and no row outside the batch's
slots and its touched rows; against the JAX package's fused insert, the
invariants and the new rows' own top-1. The in-place runner's key follows
the slabs.

With a CUDA device (``python -m pytest --noconftest -m gpu
tests/test_torch_captured_build.py``: JAX is imported inside the CPU tests
only) a captured prune phase and each captured insert are held bit for bit
against the same calls uncaptured, and a replay's launch counts against
the uncaptured call's.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.index import build_phases, captured
from alayalite_tpu_torch.index import engine as engine_mod
from alayalite_tpu_torch.index import fused_insert
from alayalite_tpu_torch.spaces.raw import RawSpace, put_rows

torch.set_num_threads(2)

DIM = 16


def _grid_rows(rng, n):
    """Quarter-integer rows in [0, 63.75]: bf16 holds them exactly."""
    return rng.integers(0, 256, size=(n, DIM)).astype(np.float32) / 4


def _dists(x, q_ids, cand, metric):
    """Exact distances (f64, exact in f32 here) from rows ``q_ids`` to the
    candidate ids, inf on −1."""
    xd = x.astype(np.float64)
    c = np.where(cand >= 0, cand, 0)
    if metric == "ip":
        d = -(xd[c] * xd[q_ids][:, None, :]).sum(-1)
    else:
        d = ((xd[c] - xd[q_ids][:, None, :]) ** 2).sum(-1)
    return np.where(cand >= 0, d, np.inf).astype(np.float32)


def _phase_inputs(metric, n=1500, m=48, seed=0):
    """(JAX space, port space, rows, candidates d / i with self-edges,
    repeats and −1)."""
    from alayalite_tpu.spaces.raw import RawSpace as JaxRaw

    rng = np.random.default_rng(seed)
    x = _grid_rows(rng, n)
    ci = rng.integers(0, n, size=(n, m)).astype(np.int32)
    ci[rng.random((n, m)) < 0.08] = -1
    ci[::9, 3] = np.arange(n, dtype=np.int32)[::9]            # self-edges
    ci[::5, 7] = ci[::5, 6]                                    # repeats
    cd = _dists(x, np.arange(n), ci, metric)
    return (JaxRaw.create(n, DIM, metric=metric).fit(x),
            RawSpace.create(n, DIM, metric=metric).fit(torch.from_numpy(x)),
            x, cd, ci)


# ------------------------------------------------------- phases against JAX
@pytest.mark.parametrize("alpha,metric", [(1.0, "l2"), (1.2, "l2"),
                                          (1.2, "ip")])
def test_prune_all_matches_jax(alpha, metric):
    """``prune_all_dev`` over 1500 rows in chunks of 512 (the tail chunk
    overlaps): the ids JAX's gives."""
    import jax.numpy as jnp

    from alayalite_tpu.index.build_phases import prune_all_dev as jax_prune

    jsp, sp, _, cd, ci = _phase_inputs(metric)
    want = np.asarray(jax_prune(jsp, jnp.asarray(cd), jnp.asarray(ci), r=16,
                                alpha=alpha, chunk=512))
    got = build_phases.prune_all_dev(sp, torch.from_numpy(cd),
                                     torch.from_numpy(ci), r=16, alpha=alpha,
                                     chunk=512)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum(1).min() > 0


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_reprune_with_reverse_matches_jax(alpha):
    """``reprune_with_reverse_dev`` on one adjacency and reverse table
    (self-edges, repeats and −1 in both): the ids JAX's gives."""
    import jax.numpy as jnp

    from alayalite_tpu.index.build_phases import \
        reprune_with_reverse_dev as jax_reprune

    jsp, sp, _, _, ci = _phase_inputs("l2", seed=1)
    nbrs, rev = ci[:, :16].copy(), ci[:, 16:48].copy()
    rev[::3, 5] = nbrs[::3, 2]
    want = np.asarray(jax_reprune(jsp, jnp.asarray(nbrs), jnp.asarray(rev),
                                  r=16, alpha=alpha, chunk=512))
    got = build_phases.reprune_with_reverse_dev(
        sp, torch.from_numpy(nbrs), torch.from_numpy(rev), r=16, alpha=alpha,
        chunk=512)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fill_degree_matches_jax():
    """``fill_degree_dev`` on thinned rows: the ids JAX's gives."""
    import jax.numpy as jnp

    from alayalite_tpu.index.build_phases import \
        fill_degree_dev as jax_fill

    _, _, _, cd, ci = _phase_inputs("l2", seed=2)
    rng = np.random.default_rng(3)
    nbrs = ci[:, :16].copy()
    nbrs[rng.random(nbrs.shape) < 0.5] = -1
    want = np.asarray(jax_fill(jnp.asarray(nbrs), jnp.asarray(cd),
                               jnp.asarray(ci), r=16, chunk=512))
    got = build_phases.fill_degree_dev(torch.from_numpy(nbrs),
                                       torch.from_numpy(cd),
                                       torch.from_numpy(ci), r=16, chunk=512)
    np.testing.assert_array_equal(got.numpy(), want)


def test_twohop_pool_matches_jax_tail():
    """``twohop_pool_dev`` with an overlapping tail chunk: the ids and the
    distances JAX's gives."""
    import jax.numpy as jnp

    from alayalite_tpu.index.build_phases import \
        twohop_pool_dev as jax_twohop

    jsp, sp, _, _, ci = _phase_inputs("l2", n=1100, seed=4)
    knn = ci[:, :12].copy()
    jd, ji = (np.asarray(a) for a in jax_twohop(jsp, jnp.asarray(knn), ef=24,
                                                n=1100, chunk=512))
    gd, gi = build_phases.twohop_pool_dev(sp, torch.from_numpy(knn), ef=24,
                                          n=1100, chunk=512)
    np.testing.assert_array_equal(gi.numpy(), ji)
    np.testing.assert_array_equal(gd.numpy(), jd)


# ------------------------------------------------------------ chunk runner
@pytest.mark.parametrize("n,chunk", [(1500, 512), (1024, 512), (300, 512),
                                     (4097, 4096)])
def test_chunk_runner_rows(n, chunk):
    """Each chunk's row ids are lo + arange(chunk) for the starts JAX's
    ``_chunks`` gives (the tail overlapping), every row written once with
    its own values and the tail's rows twice with the same."""
    from alayalite_tpu.index.build_phases import _chunks as jax_chunks

    starts, c = captured.chunk_starts(n, chunk)
    assert (starts, c) == jax_chunks(n, chunk)
    x = torch.arange(n * 3, dtype=torch.float32).view(n, 3)
    seen = []

    def fn(rows, xc):
        seen.append(rows.clone())
        return rows[:, None] * 10, xc * 2

    rows, doubled = captured.run_chunks("t", fn, n, chunk, (x,))
    assert [int(s[0]) for s in seen] == starts
    for s in seen:
        assert torch.equal(s, torch.arange(int(s[0]), int(s[0]) + c,
                                           dtype=torch.int32))
    assert torch.equal(rows[:, 0], torch.arange(n, dtype=torch.int32) * 10)
    assert torch.equal(doubled, x * 2)


def test_put_rows_masks():
    """Masked entries write no row: a kept id's row lands, a masked −1 or
    a masked real id changes nothing, and with nothing kept nothing
    changes."""
    dst = torch.arange(12, dtype=torch.int32).view(6, 2)
    ids = torch.tensor([3, -1, 0, 3, 5])
    rows = torch.tensor([[7, 7], [9, 9], [8, 8], [7, 7], [6, 6]],
                        dtype=torch.int32)
    keep = torch.tensor([True, False, False, True, False])
    want = dst.clone()
    want[3] = 7
    put_rows(dst, ids, rows, keep)
    assert torch.equal(dst, want)
    put_rows(dst, ids, rows, torch.zeros(5, dtype=torch.bool))
    assert torch.equal(dst, want)


# ------------------------------------------------------------ padded inserts
def _fitted(kind, capacity, n=600, seed=7):
    """A fitted hnsw index (bsq8 or raw) over quarter-integer rows / 16:
    every sum of a batch's own products is exact, whatever its order."""
    rows = _grid_rows(np.random.default_rng(seed), n) / 16
    quant = "bsq8" if kind == "bsq8" else "none"
    idx = Index(kind, IndexParams(index_type="hnsw", quantization_type=quant,
                                  max_nbrs=16, ef_construction=64,
                                  capacity=capacity), device="cpu")
    idx.fit(rows)
    return idx


_FITTED = {}


def _engine(kind, capacity):
    """A deep copy of one fitted engine per (kind, capacity)."""
    if (kind, capacity) not in _FITTED:
        _FITTED[kind, capacity] = _fitted(kind, capacity)._engine
    return copy.deepcopy(_FITTED[kind, capacity])


def _live(eng) -> dict:
    """The tensors an insert writes."""
    out = {"nbrs": eng.graph.nbrs, "data": eng.space.data,
           "sq": eng.space.sq_norms, "valid": eng.space.valid}
    for name, sp in (("search", eng.search_space),
                     ("shadow", eng._ins_shadow)):
        if sp is not None and sp is not eng.space:
            for f in ("nbr_ids", "nbr_codes", "nbr_xsq", "data", "sq_norms",
                      "valid"):
                out[f"{name}.{f}"] = getattr(sp, f)
    return out


def _state(eng) -> dict:
    return {k: v.clone() for k, v in _live(eng).items()}


_CASES = {1: (1, 5000), 63: (63, 5000), 64: (64, 5000), 65: (65, 5000),
          4097: (4097, 5000), "overflow": (40, 620), "sparse": (50, 5000)}


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("kind", ["bsq8", "raw"])
def test_padded_insert_matches_unpadded(kind, case, monkeypatch):
    """``IndexEngine.insert`` pads each slice to its bucket; the same
    engine with the bucket the slice's own size runs the fused steps
    unpadded on the same rows and slots. Same ids, same adjacency, blocks,
    rows, norms and valid; no row changes outside the new slots and the
    rows their edges touch. "overflow": the last 20 rows do not fit;
    "sparse": all but 6 of the fitted rows removed first, so searched rows
    have fewer than r edges. The raw index inserts through its bsq8 shadow."""
    monkeypatch.setattr(engine_mod, "SHADOW_MIN_ROWS", 0)
    rows, capacity = _CASES[case]
    base = _engine(kind, capacity)
    if case == "sparse":
        base.remove(np.setdiff1d(np.arange(600), np.arange(0, 600, 100)))
    if kind == "raw":
        base._ensure_ins_shadow()
    rng = np.random.default_rng(rows)
    x = (_grid_rows(rng, rows) / 16).astype(np.float32)
    before = _state(base)
    touched = []
    real_table = fused_insert._reverse_table

    def spy(dst, real, *a):
        touched.append(dst[real].clone())
        return real_table(dst, real, *a)

    monkeypatch.setattr(fused_insert, "_reverse_table", spy)
    got = {}
    for mode in ("padded", "unpadded"):
        eng = copy.deepcopy(base)
        if mode == "unpadded":
            monkeypatch.setattr(engine_mod, "bucket", lambda b: b)
        touched.clear()
        ids = eng.insert(x)
        got[mode] = (ids, _state(eng), torch.cat(touched))
    ids, state, hit = got["padded"]
    np.testing.assert_array_equal(ids, got["unpadded"][0])
    n0 = 600
    fit = min(rows, capacity - n0)
    assert (ids[:fit] == np.arange(n0, n0 + fit)).all()
    assert (ids[fit:] == -1).all()
    for k, v in state.items():
        assert torch.equal(v, got["unpadded"][1][k]), k
    assert torch.equal(torch.sort(hit).values,
                       torch.sort(got["unpadded"][2]).values)
    allowed = torch.zeros(capacity, dtype=torch.bool)
    allowed[torch.as_tensor(ids[ids >= 0]).long()] = True
    allowed[hit.long()] = True
    for k in ("nbrs", "search.nbr_ids", "search.nbr_codes",
              "shadow.nbr_ids", "shadow.nbr_codes"):
        if k in state:
            diff = (state[k] != before[k]).reshape(capacity, -1).any(1)
            assert not (diff & ~allowed).any(), k
    if case == "sparse":
        new_rows = state["nbrs"][torch.as_tensor(ids).long()]
        assert ((new_rows >= 0).sum(1) < 16).any()


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_block_insert_against_jax(metric):
    """The JAX package's fused insert at its bucket and the port's, on one
    fitted index each: the same ids (−1 past the capacity), every new row
    linked, every block in step with its row, and the new rows found as
    their own top-1 in both."""
    from alayalite_tpu import Index as JaxIndex
    from alayalite_tpu import IndexParams as JaxParams
    from alayalite_tpu_torch.spaces.bqg import _encode_block
    from alayalite_tpu_torch.utils.datasets import random_dataset

    ds = random_dataset(n=600, dim=DIM, n_queries=4, seed=17)
    kw = dict(index_type="hnsw", quantization_type="bsq8", max_nbrs=16,
              ef_construction=64, capacity=640, metric=metric)
    jidx = JaxIndex("j", JaxParams(**kw))
    idx = Index("p", IndexParams(**kw), device="cpu")
    jidx.fit(ds.data)
    idx.fit(ds.data)
    rng = np.random.default_rng(2)
    new = ds.data[:50] + 0.01 * rng.normal(size=(50, DIM)).astype(np.float32)
    want = jidx._engine.insert(new)
    got = idx._engine.insert(new)
    np.testing.assert_array_equal(got, want)
    ok = got >= 0
    assert ok.sum() == 40
    eng = idx._engine
    sp = eng.search_space
    assert (eng.graph.nbrs[torch.as_tensor(got[ok])] >= 0).any(1).all()
    codes, xsq = _encode_block(sp.data, sp.dmin, sp.scale, sp.nbr_ids[:640])
    assert torch.equal(codes, sp.nbr_codes[:640])
    assert torch.equal(xsq, sp.nbr_xsq[:640])
    assert torch.equal(eng.graph.nbrs, sp.nbr_ids)
    for index, ids in ((jidx, want), (idx, got)):
        top = index.batch_search(new[:40], 1, ef_search=64)[:, 0]
        assert (top == ids[:40]).mean() >= 0.9


def test_inplace_key_follows_the_slabs(tmp_path):
    """The in-place runner's key (the state of what the connect step writes
    and reads) stays put across an insert, which moves only ``num``, and
    changes with a reallocated adjacency, a load and another capacity."""
    idx = _fitted("bsq8", 700)
    eng = idx._engine

    def key(e):
        return captured._walk((e.search_space, e.graph.nbrs), [])

    before = key(eng)
    idx.insert(np.ones((3, DIM), np.float32))
    assert key(eng) == before
    nbrs = eng.graph.nbrs
    eng.graph.nbrs = nbrs.clone()
    assert key(eng) != before
    eng.graph.nbrs = nbrs
    idx.save(str(tmp_path))
    back = Index.load(str(tmp_path.parent), tmp_path.name, device="cpu")
    assert key(back._engine) != before
    assert key(_fitted("bsq8", 720)._engine) != before


# ----------------------------------------------------------------- the card
def _cuda_engine(kind, n=20_000):
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.utils.datasets import random_dataset

    ds = random_dataset(n=n + 4096, dim=64, n_queries=4, seed=13)
    quant = {"bsq8": "bsq8", "raw": "none"}[kind]
    idx = Client().create_index(f"b{kind}", index_type="hnsw",
                                quantization_type=quant, capacity=n + 4096)
    idx.fit(ds.data[:n])
    return idx._engine, torch.as_tensor(ds.data[n:], device="cuda")


def _snapshot(eng):
    """The tensors an insert writes, and a restore of them in place."""
    saved = _state(eng)
    nums = (eng.space.num, eng.search_space.num)

    def restore():
        for k, v in _live(eng).items():
            v.copy_(saved[k])
        eng.space.num, eng.search_space.num = nums
        if eng._ins_shadow is not None:
            eng._ins_shadow.num = nums[0]
        eng._insert_gen = None
    return restore


@pytest.mark.gpu
@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_cuda_prune_captured_equals_uncaptured(alpha):
    """``prune_all_dev`` over a 20k raw space's candidates: every chunk
    replayed gives the bits of the uncaptured chunk, and a replay adds the
    launches of an uncaptured call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    eng, _ = _cuda_engine("raw")
    sp = eng.space
    n = sp.num
    g = torch.Generator(device="cuda").manual_seed(0)
    ci = torch.randint(0, n, (n, 160), generator=g, device="cuda",
                       dtype=torch.int32)
    cd = sp.gather_dists(sp.data[:n], ci)
    with captured.eager():
        want = build_phases.prune_all_dev(sp, cd, ci, r=32, alpha=alpha)
    got = build_phases.prune_all_dev(sp, cd, ci, r=32, alpha=alpha)
    assert torch.equal(got, want)
    before = captured.counts()
    with captured.eager():
        build_phases.prune_all_dev(sp, cd, ci, r=32, alpha=alpha)
    mid = captured.counts()
    build_phases.prune_all_dev(sp, cd, ci, r=32, alpha=alpha)
    after = captured.counts()
    assert all(after[k] - mid[k] == mid[k] - before[k] for k in before)
    assert any(mid[k] > before[k] for k in before)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bsq8", "raw"])
def test_cuda_insert_captured_equals_uncaptured(kind, monkeypatch):
    """A 4096-row and a 50-row insert into a 20k index (the raw one
    through its shadow), captured and uncaptured from the same state: the
    same ids and the same written tensors, bit for bit, twice; the
    replays add the uncaptured call's launches."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    monkeypatch.setattr(engine_mod, "SHADOW_MIN_ROWS", 0)
    eng, x = _cuda_engine(kind)
    if kind == "raw":
        eng._ensure_ins_shadow()
    restore = _snapshot(eng)
    rng_state = copy.deepcopy(eng._rng)
    for rows in (4096, 50):
        results = {}
        for mode in (False, True, True):      # the second replays only
            restore()
            eng._rng = copy.deepcopy(rng_state)
            before = captured.counts()
            with contextlib.nullcontext() if mode else captured.eager():
                ids = eng.insert(x[:rows].cpu().numpy())
            delta = {k: v - before[k] for k, v in captured.counts().items()}
            results[mode] = (ids, _state(eng), delta)
        np.testing.assert_array_equal(results[True][0], results[False][0])
        for k, v in results[False][1].items():
            assert torch.equal(results[True][1][k], v), k
        assert results[True][2] == results[False][2]
