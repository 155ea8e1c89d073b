"""The search loops without a host test and the captured slices.

On the CPU the port's fixed-hop loops (exactly ``max_iters`` hops) are held
bit for bit against the JAX package's early-stopping ``lax.while_loop``s:
``beam_search`` on a raw space, ``block_beam_search`` on a bsq8 space and
on a 1-bit rabitq space (its result pool), the chunked ``overlay_descend``
on a level where a query walks more than ``DESCENT_CHUNK`` steps, and a
50-query batch that ``block_search_device`` pads to 64 rows. Bit for bit needs
sums whose value does not depend on their order: the rows and queries are
quarter-integers (so every product and sum of a distance is exact in f32,
the bsq8 grid step is exactly 0.25 and every q * scale is exact in bf16),
the rabitq rotation is a signed permutation and its factors are rounded to
quarters. Then a no-op hop is shown to leave a query's pools as they were,
and the capture key to follow the slabs' pointers.

With a CUDA device (``python -m pytest --noconftest -m gpu
tests/test_torch_captured.py``: JAX is imported inside the CPU tests only)
a captured search is held bit for bit against the same function uncaptured
(inside ``captured.eager()``) on a 20k bsq8 and a 20k raw hnsw index, a
search inside that scope is shown to capture nothing, and the launch
counters, the graph per bucket and two threads on one index are checked.
"""

import contextlib
import math
import threading

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.index import captured, search
from alayalite_tpu_torch.spaces.bqg import BQGSpace
from alayalite_tpu_torch.spaces.rabitq import RaBitQSpace
from alayalite_tpu_torch.spaces.raw import RawSpace

torch.set_num_threads(2)

N, DIM, NQ = 400, 16, 24
ITERS = 60            # far above the hops these queries need


def _grid_rows(rng, n):
    """Quarter-integer rows in [0, 63.75]; row 0 all 0, row 1 all 63.75,
    so the bsq8 grid is dmin 0, scale 0.25 exactly."""
    x = rng.integers(0, 256, size=(n, DIM)).astype(np.float32) / 4
    x[0], x[1] = 0.0, 63.75
    return x


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = _grid_rows(rng, N)
    q = _grid_rows(rng, NQ + 2)[2:]
    nbrs = rng.integers(0, N, size=(N, 32)).astype(np.int32)
    nbrs[::7, -5:] = -1
    seeds = rng.integers(0, N, size=(NQ, 3)).astype(np.int32)
    seeds[::5, 2] = -1
    valid = np.ones(N, dtype=bool)
    valid[::11] = False
    return x, q, nbrs, seeds, valid


def _spaces(x, nbrs, kind):
    """(JAX space, port space) holding the same arrays."""
    if kind == "raw":
        from alayalite_tpu.spaces.raw import RawSpace as JaxRaw

        return (JaxRaw.create(N, DIM).fit(x),
                RawSpace.create(N, DIM).fit(torch.from_numpy(x)))
    if kind == "bsq8":
        from alayalite_tpu.spaces.bqg import BQGSpace as JaxBQG

        jsp = JaxBQG.create(N, DIM, degree=32).fit(x).update_neighbors(nbrs)
        arrays = jsp.save_arrays()
        assert np.all(arrays["scale"] == 0.25) and np.all(arrays["dmin"] == 0)
        return jsp, BQGSpace.load_arrays(arrays)
    from alayalite_tpu.spaces.rabitq import RaBitQSpace as JaxRaBitQ

    rng = np.random.default_rng(5)
    rot = np.zeros((DIM, DIM), np.float32)
    rot[np.arange(DIM), rng.permutation(DIM)] = rng.choice([-1.0, 1.0], DIM)
    arrays = JaxRaBitQ.create(N, DIM, rot=rot).fit(x).update_neighbors(
        nbrs).save_arrays()
    for key in ("f_add", "f_rescale"):
        arrays[key] = np.round(arrays[key] * 4) / 4
    return JaxRaBitQ.load_arrays(arrays), RaBitQSpace.load_arrays(arrays)


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("visited_mode", ["ring", "bitmask"])
@pytest.mark.parametrize("ef,m", [(16, 2), (32, 4)])
def test_fixed_hops_match_jax_raw(data, visited_mode, ef, m):
    """``beam_search`` runs all ITERS hops; JAX's loop stops when no query
    has an unchecked entry: the same ids and distances, bit for bit."""
    import jax.numpy as jnp

    from alayalite_tpu.index.search import beam_search as jax_beam

    x, q, nbrs, seeds, valid = data
    jsp, sp = _spaces(x, nbrs, "raw")
    want = jax_beam(jsp, jnp.asarray(nbrs), jnp.asarray(seeds),
                    jnp.asarray(q), k=10, ef=ef, max_iters=ITERS,
                    valid=jnp.asarray(valid), n_expand=m,
                    visited_mode=visited_mode)
    got = search.beam_search(sp, torch.from_numpy(nbrs),
                             torch.from_numpy(seeds), torch.from_numpy(q),
                             k=10, ef=ef, max_iters=ITERS,
                             valid=torch.from_numpy(valid), n_expand=m,
                             visited_mode=visited_mode)
    _equal(got, want)
    assert (got[1] >= 0).all()


@pytest.mark.parametrize("kind", ["bsq8", "rabitq"])
@pytest.mark.parametrize("ef,m", [(16, 2), (32, 4)])
def test_fixed_hops_match_jax_block(data, kind, ef, m):
    """``block_beam_search`` over ITERS hops against JAX's early-stopping
    loop, bsq8 and 1-bit rabitq (with its result pool): the same bits."""
    import jax.numpy as jnp

    from alayalite_tpu.index.search import block_beam_search as jax_block

    x, q, nbrs, seeds, valid = data
    jsp, sp = _spaces(x, nbrs, kind)
    assert getattr(sp, "bits", 0) == (1 if kind == "rabitq" else 0)
    want = jax_block(jsp, jnp.asarray(seeds), jnp.asarray(q), k=10, ef=ef,
                     max_iters=ITERS, valid=jnp.asarray(valid), n_expand=m)
    got = search.block_beam_search(sp, torch.from_numpy(seeds),
                                   torch.from_numpy(q), k=10, ef=ef,
                                   max_iters=ITERS,
                                   valid=torch.from_numpy(valid), n_expand=m)
    _equal(got, want)
    assert (got[1] >= 0).all()


def _live(pool_i, *cols):
    """Each row's entries with an id >= 0, in order."""
    return [tuple(c[b][pool_i[b] >= 0].tolist() for c in (pool_i, *cols))
            for b in range(pool_i.shape[0])]


@pytest.mark.parametrize("kind", ["raw", "bsq8", "rabitq"])
def test_noop_hop_keeps_pools(data, kind):
    """Once a query has no unchecked entry, a hop leaves its pool's live
    entries, its pop ring's live entries (the ring shifts in −1) and the
    1-bit result pool as they were."""
    x, q, nbrs, seeds, _ = data
    _, sp = _spaces(x, nbrs, kind)
    qt, st = torch.from_numpy(q), torch.from_numpy(seeds)
    nb = torch.from_numpy(nbrs)
    L, M, k = 16, 2, 10
    if kind == "raw":
        state = search._beam_start(sp, st, qt, N, L, M, ITERS, True)

        def hop(state):
            return search._beam_hop(sp, nb, qt, *state, M, L, True)
    else:
        ctx, state = search._block_start(sp, st, qt, k, L, M, ITERS)
        res_pool = kind == "rabitq"

        def hop(state):
            return search._block_hop(sp, ctx, qt, *state, M, L, k, res_pool)

    for _ in range(ITERS // 2):
        state = hop(state)
    pool_d, pool_i, pool_c = state[1:4]
    assert not search._has_next(pool_d, pool_i, pool_c).any()
    after = hop(state)
    assert _live(after[2], after[1], after[3]) == _live(pool_i, pool_d,
                                                        pool_c)
    assert _live(after[0]) == _live(state[0])
    if kind != "raw":
        assert torch.equal(after[4], state[4])
        assert torch.equal(after[5], state[5])
    assert (after[0][:, -M:] == -1).all()


def test_chunked_descent_matches_jax(monkeypatch):
    """A level that is a path (neighbors j - 1 and j + 1 along a line):
    from slot 0 a query at the far end walks 39 steps, more than
    DESCENT_CHUNK. The chunked descent lands every query on JAX's node,
    with ceil(steps / DESCENT_CHUNK) host tests."""
    import jax.numpy as jnp

    from alayalite_tpu.index.search import overlay_descend as jax_descend
    from alayalite_tpu.spaces.raw import RawSpace as JaxRaw

    n = 40
    x = np.zeros((n, DIM), np.float32)
    x[:, 0] = np.arange(n)
    nb = np.full((n, 4), -1, np.int32)
    nb[1:, 0] = np.arange(n - 1)
    nb[:-1, 1] = np.arange(1, n)
    ids = np.arange(n, dtype=np.int32)
    q = np.zeros((6, DIM), np.float32)
    q[:, 0] = [39, 38.75, 20, 7.25, 0, 12]
    start = np.zeros(6, np.int32)
    want = jax_descend(JaxRaw.create(n, DIM).fit(x), jnp.asarray(ids),
                       jnp.asarray(nb), jnp.asarray(ids), jnp.asarray(start),
                       jnp.asarray(q))
    sp = RawSpace.create(n, DIM).fit(torch.from_numpy(x))
    args = (sp, torch.from_numpy(ids), torch.from_numpy(nb),
            torch.from_numpy(ids), torch.from_numpy(start),
            torch.from_numpy(q))
    assert search.DESCENT_CHUNK < n - 1
    syncs = search.overlay_descend.syncs
    got = search.overlay_descend(*args)
    syncs = search.overlay_descend.syncs - syncs
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [39, 39, 20, 7, 0, 12]
    # 39 moves and the step that finds no better neighbor
    assert syncs == math.ceil(40 / search.DESCENT_CHUNK)
    monkeypatch.setattr(search, "DESCENT_CHUNK", 1)
    syncs = search.overlay_descend.syncs
    assert torch.equal(search.overlay_descend(*args), got)
    assert search.overlay_descend.syncs - syncs == 40


def test_padded_batch_matches_jax_and_unpadded(data):
    """50 queries: ``block_search_device`` pads them to the 64-row bucket (as the
    JAX engine pads) and returns 50 rows, JAX's ids and distances for the
    padded batch, and the rows of the unpadded beam."""
    import jax.numpy as jnp

    from alayalite_tpu.index.search import block_search_device as jax_bsd

    x, _, nbrs, _, valid = data
    jsp, sp = _spaces(x, nbrs, "bsq8")
    q = _grid_rows(np.random.default_rng(3), 52)[2:]
    assert captured.slice_rows(50, 4096) == (64, 64)
    eps = np.array([5, 17], np.int32)
    qp = np.concatenate([q, np.zeros((14, DIM), np.float32)])
    want = jax_bsd(jsp, jnp.asarray(eps), jnp.asarray(qp), k=10, ef=16,
                   valid=jnp.asarray(valid), n_expand=2, qchunk=64)
    calls = search.ring_probe.calls
    d, i = search.block_search_device(sp, torch.from_numpy(eps),
                                      torch.from_numpy(q), k=10, ef=16,
                                      valid=torch.from_numpy(valid),
                                      n_expand=2)
    hops = search.ring_probe.calls - calls
    assert d.shape == (50, 10) and hops == search._default_iters(16, 2, 0)
    _equal((d, i), (np.asarray(want[0])[:50], np.asarray(want[1])[:50]))
    one = search.block_beam_search(
        sp, torch.from_numpy(eps)[None].expand(50, -1), torch.from_numpy(q),
        k=10, ef=16, valid=torch.from_numpy(valid), n_expand=2)
    assert torch.equal(one[0], d) and torch.equal(one[1], i)


def test_bucket_list():
    """The JAX engine's buckets and slices."""
    assert [captured.bucket(b) for b in (1, 64, 65, 1000, 4097, 16385)] == [
        64, 64, 256, 1024, 16384, 20480]
    assert captured.slice_rows(8192, 4096) == (4096, 8192)
    assert captured.slice_rows(5000, 1024) == (1024, 5120)
    assert captured.slice_rows(300, 4096) == (1024, 1024)


def test_capture_key_follows_the_slabs(tmp_path):
    """The key of a search's reads changes when a slab is reallocated (a
    load, a new valid, new codes, a new seed sample) and stays put across
    what writes in place: an insert (which moves only ``num``), a remove's
    tombstones and the bsq8 compaction's rewiring."""
    from alayalite_tpu_torch import Index, IndexParams
    from alayalite_tpu_torch.utils.datasets import random_dataset

    ds = random_dataset(n=1100, dim=DIM, n_queries=4, seed=4)
    idx = Index("k", IndexParams(index_type="hnsw", quantization_type="bsq8",
                                 capacity=1300, max_nbrs=16), device="cpu")
    idx.fit(ds.data[:1000])
    eng = idx._engine

    def key(*extra):
        sp = eng.search_space
        return captured._walk((sp, eng.graph.eps, eng.space.valid, *extra),
                              [])

    before = key()
    num = eng.search_space.num
    idx.insert(ds.data[1000:1050])
    assert eng.search_space.num == num + 50 and key() == before
    sample = eng._seed_scan_arrays()
    eng._sscan = None
    eng._mutations += 1
    assert captured._walk(eng._seed_scan_arrays(), []) != captured._walk(
        sample, [])
    old_valid = eng.space.valid
    eng.space.valid = old_valid.clone()
    assert key() != before
    eng.space.valid = old_valid
    idx.remove([3, 5, 8])
    assert key() == before                      # tombstones are in place
    eng.compact()
    assert key() == before
    sp = eng.search_space
    codes = sp.nbr_codes
    sp.nbr_codes = codes.clone()
    assert key() != before
    sp.nbr_codes = codes
    idx.save(str(tmp_path))
    back = Index.load(str(tmp_path.parent), tmp_path.name, device="cpu")
    assert captured._walk((back._engine.search_space,), []) != \
        captured._walk((eng.search_space,), [])


def test_cpu_runs_uncaptured():
    """On the CPU ``run`` calls the function as it is: no graph, no key."""
    out = captured.run("t", lambda a: (a + 1,), (torch.zeros(3, 2),),
                       reads=(object(),))
    assert torch.equal(out[0], torch.ones(3, 2))
    assert captured.cached() == 0


class _OnCard:
    """Stands in for a [4, 2] f32 tensor on the card: what ``run`` and
    ``run_inplace`` read of an input before they replay."""
    device = torch.device("cuda")
    shape = (4, 2)
    dtype = torch.float32


def test_eager_scope(monkeypatch):
    """``eager()`` nests, is left on an exception and is this thread's
    alone; inside it ``run``, ``run_chunks`` and ``run_inplace`` call
    ``fn`` as it is, where outside it a card input goes to a replay."""
    def replay(*args, **kwargs):
        raise AssertionError("replayed")

    monkeypatch.setattr(captured, "_replay", replay)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    card, x = torch.device("cuda"), _OnCard()

    def fn(*xs):
        return xs

    with pytest.raises(AssertionError, match="replayed"):
        captured.run("t", fn, (x,))
    with pytest.raises(AssertionError, match="replayed"):
        captured.run_inplace("t", fn, (x,), (x,))
    assert not captured._uncaptured(card)
    with captured.eager():
        with captured.eager():
            assert captured._uncaptured(card)
        assert captured._uncaptured(card)
        assert captured.run("t", fn, (x,), reads=(object(),)) == (x,)
        assert captured.run_inplace("t", fn, (x,), (x,),
                                    writes=(object(),)) == (x,)
        rows = torch.arange(5.0)[:, None]
        got = captured.run_chunks("t", lambda ids, r: (r * 2 + ids[:, None],),
                                  5, 2, (rows,), reads=(object(),))
        assert torch.equal(got[0], rows * 3)
        seen = []
        other = threading.Thread(
            target=lambda: seen.append(captured._uncaptured(card)))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive() and seen == [False]
    assert not captured._uncaptured(card)
    with pytest.raises(ValueError):
        with captured.eager():
            with captured.eager():
                raise ValueError("inside two scopes")
    assert not captured._uncaptured(card)
    assert captured.cached() == 0


# ----------------------------------------------------------------- the card
def _cuda_index(kind: str, n: int = 20_000):
    from alayalite_tpu_torch import Client
    from alayalite_tpu_torch.utils.datasets import random_dataset

    ds = random_dataset(n=n, dim=64, n_queries=1200, seed=13)
    quant = {"bsq8": "bsq8", "raw": "none"}[kind]
    idx = Client().create_index(f"c{kind}", index_type="hnsw",
                                quantization_type=quant, capacity=n)
    idx.fit(ds.data)
    return idx, torch.as_tensor(ds.queries, device="cuda")


def _slice_search(idx, q, ef, capture):
    eng = idx._engine
    g, p = eng.graph, eng.params
    with contextlib.nullcontext() if capture else captured.eager():
        if eng.params.quantization_type.is_block:
            return search.block_search_device(
                eng.search_space, g.eps, eng.search_space.prep_query(q), k=10,
                ef=ef, valid=eng.space.valid, max_iters=p.search_iters,
                n_expand=p.beam_expand, seed_sample=eng._seed_scan_arrays())
        return search.graph_search_device(
            eng.space, g.nbrs, g.eps, g.overlay, eng.space.prep_query(q),
            k=10, ef=ef, max_iters=p.search_iters, valid=eng.space.valid,
            n_expand=p.beam_expand)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bsq8", "raw"])
def test_cuda_captured_equals_uncaptured(kind):
    """A 20k index: every slice replayed from its graph gives the bits of
    the same function run uncaptured, at two efs and two batch sizes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    idx, q = _cuda_index(kind)
    for ef in (32, 64):
        for rows in (1200, 50):
            want = _slice_search(idx, q[:rows], ef, False)
            for _ in range(2):
                got = _slice_search(idx, q[:rows], ef, True)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cuda_eager_scope_captures_nothing():
    """Searches inside ``eager()`` (and through ``_batch_search_impl``'s
    ``_capture=False``) capture no graph, hold none and replay none, and
    give the bits of the replays that follow."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    idx, q = _cuda_index("bsq8")
    eng = idx._engine
    captured.clear()
    before = dict(captured.stats)
    with captured.eager():
        eager = [eng._batch_search_impl(q[:rows], 10, 64)
                 for rows in (50, 1200)]
    flag = [eng._batch_search_impl(q[:rows], 10, 64, _capture=False)
            for rows in (50, 1200)]
    assert captured.stats["captures"] == before["captures"]
    assert captured.stats["replays"] == before["replays"]
    assert captured.cached() == 0
    for rows, want, also in zip((50, 1200), eager, flag):
        for _ in range(2):                     # the capture, then a replay
            got = eng._batch_search_impl(q[:rows], 10, 64)
            for a, b, c in zip(got, want, also):
                assert torch.equal(a, b) and torch.equal(a, c)
    assert captured.stats["captures"] - before["captures"] >= 2
    assert captured.stats["replays"] - before["replays"] >= 4


@pytest.mark.gpu
def test_cuda_replay_counts_launches():
    """Three replays add three times one eager call's launches to every
    kernel counter."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    idx, q = _cuda_index("bsq8")
    _slice_search(idx, q, 64, True)                # captures
    before = captured.counts()
    _slice_search(idx, q, 64, False)
    mid = captured.counts()
    for _ in range(3):
        _slice_search(idx, q, 64, True)
    after = captured.counts()
    once = {k: mid[k] - before[k] for k in before}
    assert once[(search.ring_probe, "launches", None)] > 0
    assert all(after[k] - mid[k] == 3 * once[k] for k in before)


@pytest.mark.gpu
def test_cuda_graph_per_bucket():
    """Batches of 10 and 50 share the 64-row graph; 200 and 1000 rows
    take one graph each (256, 1024); a repeat captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    idx, q = _cuda_index("bsq8")
    captured.clear()
    n0 = captured.stats["captures"]
    for rows in (10, 50, 200, 1000, 50, 1000):
        idx.batch_search(q[:rows].cpu().numpy(), 10, ef_search=64)
    assert captured.stats["captures"] - n0 == 3
    assert captured.cached() == 3


@pytest.mark.gpu
def test_cuda_threads_get_their_own_rows():
    """Twelve threads (more than the host's cores) searching one index at
    once, with a short switch interval: each gets the rows one call of its
    own queries gives, and the buckets' graphs are shared."""
    import sys

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    idx, q = _cuda_index("bsq8")
    qs = [q[t * 100:(t + 1) * 100 - t].cpu().numpy() for t in range(12)]
    want = [idx.batch_search(x, 10, ef_search=64) for x in qs]
    got = [[] for _ in qs]
    errors = []

    def worker(t):
        try:
            for _ in range(5):
                got[t].append(idx.batch_search(qs[t], 10, ef_search=64))
        except Exception as e:          # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(len(qs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    for t in range(len(qs)):
        assert len(got[t]) == 5
        assert all(np.array_equal(g, want[t]) for g in got[t])
