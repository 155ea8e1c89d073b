"""tile_topk, the flat scan's per-tile selection merged into the running
best: the plain version against a stable sort of the tile and
``merge_kv_ref`` and against a step-by-step model of the kernel (lanes that
meet a row's columns out of order, a threshold that tightens, insertions by
(key, tag)); the exact scan against the JAX package's ``exact_topk`` on
planted ties; the wrapper's routes, counts and checks; and (with a CUDA
device) the hand-written kernel against the plain version bit for bit at
the flat scan's shapes.

The rows are quarter-integer distances, so ties stand everywhere: at a
tile's k-th place, between the running best and the tile, and across
tiles; with +inf (masked rows), NaN, −0.0 and −inf among them.

The card's cases import no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_tile_topk.py``."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.ops import distance
from alayalite_tpu_torch.ops.pool_sort import merge_kv_ref, pool_merge
from alayalite_tpu_torch.ops.tile_topk import (MAX_K, tile_topk,
                                               tile_topk_ref,
                                               tile_topk_route)

KEY_NAN = 0xFFFFFFFE
KS = [1, 10, 40, 128, MAX_K]


def _tile(rng, Q, n, specials=False):
    """f32 [Q, n]: quarter integers in [0, 8), so a row ties at its k-th
    place; with specials a share of +inf, NaN, −0.0 and −inf."""
    d = rng.integers(0, 32, size=(Q, n)).astype(np.float32) / 4
    if specials:
        pick = rng.random((Q, n))
        d[pick < 0.05] = np.inf
        d[(pick >= 0.05) & (pick < 0.07)] = np.nan
        d[(pick >= 0.07) & (pick < 0.09)] = -0.0
        d[(pick >= 0.09) & (pick < 0.095)] = -np.inf
    return d


def _best(rng, Q, k, lo, fill=0.6):
    """A running best: ascending quarter integers on the same grid as the
    tiles (so it ties with them), ids below ``lo``, a tail of inf / −1."""
    d = np.sort(rng.integers(0, 32, size=(Q, k)).astype(np.float32) / 4, 1)
    d[rng.random((Q, k)) > fill] = np.inf
    d = np.sort(d, 1)
    ids = rng.integers(0, max(lo, 1), size=(Q, k)).astype(np.int32)
    ids[~np.isfinite(d)] = -1
    return d, ids


def _literal(d, lo, best_d, best_i, k):
    """The definition: a stable sort of each tile row, its first
    min(k, n), merged after the running best, −1 where not finite."""
    n = d.shape[1]
    sv, si = torch.sort(d, dim=1, stable=True)
    kk = min(k, n)
    out_d, out_i = merge_kv_ref(best_d, best_i, sv[:, :kk].contiguous(),
                                si[:, :kk].to(torch.int32) + lo, k)
    return out_d, torch.where(torch.isfinite(out_d), out_i,
                              torch.full_like(out_i, -1))


def _order_key(v):
    """The kernel's key of one f32: its bits as an unsigned integer in the
    float order, −0.0 as +0.0, every NaN after +inf."""
    v = np.float32(v)
    if np.isnan(v):
        return KEY_NAN
    if v == 0:
        return 0x80000000
    u = int(np.array(v).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


def _kernel_model(d, lo, best_d, best_i, k, vec, U):
    """The kernel's steps for each row (numpy in, numpy out): lanes take
    16-byte vectors (or single columns) a step, a survivor is an element
    not above the threshold, survivors are taken lowest lane first, lowest
    element first; each passes the exact (key, tag) test against entry
    k − 1 or is dropped; an insertion tightens the threshold and every
    lane drops its survivors above it."""
    Q, n = d.shape
    per = 4 * U
    step = 32 * per

    def column(base, e, lane):
        return (base + ((e >> 2) * 32 + lane) * 4 + (e & 3) if vec
                else base + e * 32 + lane)

    out_d = np.empty((Q, k), np.float32)
    out_i = np.empty((Q, k), np.int32)
    for q in range(Q):
        best = [(_order_key(best_d[q, e]), 0, best_d[q, e], best_i[q, e])
                for e in range(k)]
        for base in range(0, n, step):
            x = [[d[q, c] if c < n else np.float32(np.inf)
                  for c in (column(base, e, lane) for e in range(per))]
                 for lane in range(32)]
            tv = best[k - 1][2]
            if not any(not (v > tv) for row in x for v in row):
                continue
            mask = [[e for e in range(per) if not (x[lane][e] > tv)
                     and column(base, e, lane) < n] for lane in range(32)]
            while any(mask):
                src = next(lane for lane in range(32) if mask[lane])
                j = mask[src].pop(0)
                cv, c = x[src][j], column(base, j, src)
                cand = (_order_key(cv), c + 1)
                if cand < best[k - 1][:2]:
                    pos = sum(1 for b in best if b[:2] < cand)
                    best.insert(pos, (*cand, cv, lo + c))
                    best.pop()
                    tv = best[k - 1][2]
                    mask = [[e for e in m if not (x[lane][e] > tv)]
                            for lane, m in enumerate(mask)]
        for e, (_, _, v, i) in enumerate(best):
            out_d[q, e] = v
            out_i[q, e] = i if np.isfinite(v) else -1
    return out_d, out_i


def _same_bits(got, want):
    gd, gi = (torch.as_tensor(t).cpu() for t in got)
    wd, wi = (torch.as_tensor(t).cpu() for t in want)
    assert gd.shape == wd.shape and gi.shape == wi.shape
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32
    assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))
    assert torch.equal(gi, wi)


def _args(rng, Q, n, k, lo, specials=False, fill=0.6):
    d = torch.from_numpy(_tile(rng, Q, n, specials))
    bd, bi = _best(rng, Q, k, lo, fill)
    return d, lo, torch.from_numpy(bd), torch.from_numpy(bi), k


# (Q, n, k): the flat scan's k (top 10, fast mode's 40, MAX_K) and
# find_medoid's 1 on narrow tiles; tiles narrower than k; n % 4 != 0
CPU_CASES = [(24, 300, 10), (16, 700, 40), (8, 400, MAX_K), (5, 257, 1),
             (12, 6, 10), (6, 37, MAX_K), (30, 33, 33), (3, 1, 1)]


@pytest.mark.parametrize("Q,n,k", CPU_CASES)
@pytest.mark.parametrize("specials", [False, True])
def test_plain_version_equals_a_stable_sort_and_merge(Q, n, k, specials):
    rng = np.random.default_rng(Q * 131 + n + k + specials)
    args = _args(rng, Q, n, k, 5000, specials)
    _same_bits(tile_topk_ref(*args), _literal(*args))


@pytest.mark.parametrize("Q,n,k", CPU_CASES[:6])
@pytest.mark.parametrize("vec,U", [(True, 8), (False, 8), (True, 4)])
def test_plain_version_equals_the_kernels_steps(Q, n, k, vec, U):
    rng = np.random.default_rng(Q + n * 3 + k + U)
    d, lo, bd, bi, k = _args(rng, Q, n, k, 9000, specials=True)
    want = _kernel_model(d.numpy(), lo, bd.numpy(), bi.numpy(), k, vec, U)
    _same_bits(tile_topk_ref(d, lo, bd, bi, k), want)


def test_ties_keep_the_running_best_then_the_lower_column():
    d = torch.tensor([[2.0, 1.0, 1.0, 0.5, 1.0, 3.0]])
    bd = torch.tensor([[0.5, 1.0, float("inf")]])
    bi = torch.tensor([[3, 4, -1]], dtype=torch.int32)
    out = tile_topk(d, 100, bd, bi, 3)
    # the best's 0.5 before the tile's 0.5 (column 3), then the best's 1.0
    # before the tile's three; then a later tile's 0.5 after both 0.5s
    assert out[0] is bd and out[1] is bi
    assert bd.tolist() == [[0.5, 0.5, 1.0]]
    assert bi.tolist() == [[3, 103, 4]]
    tile_topk(torch.tensor([[1.0, 0.5]]), 200, bd, bi, 3)
    assert bi.tolist() == [[3, 103, 201]]


def test_wrapper_counts_calls_and_launches_nothing_on_the_cpu():
    rng = np.random.default_rng(2)
    args = _args(rng, 4, 64, 10, 100)
    want = _literal(*args)
    calls, launches = tile_topk.calls, tile_topk.launches
    routes = dict(tile_topk.route_calls)
    _same_bits(tile_topk(*args), want)
    assert tile_topk.calls == calls + 1
    assert tile_topk.launches == launches
    assert tile_topk.route_calls == routes


def test_route_depends_on_k_alone():
    assert tile_topk_route(1) == tile_topk_route(MAX_K) == "kernel"
    assert tile_topk_route(MAX_K + 1) == "wide"


@pytest.mark.parametrize("what", ["dtype", "shape", "ids", "contiguous",
                                  "k", "lo"])
def test_wrapper_raises_on_bad_inputs(what):
    d, lo, bd, bi, k = _args(np.random.default_rng(3), 4, 32, 10, 64)
    if what == "dtype":
        d = d.double()
    elif what == "shape":
        bd = bd[:, :5].contiguous()
    elif what == "ids":
        bi = bi.long()
    elif what == "contiguous":
        d = torch.cat([d, d], 1)[:, ::2]
    elif what == "k":
        bd, bi, k = bd[:, :0], bi[:, :0], 0
    else:
        lo = 2**31 - 8
    with pytest.raises((TypeError, ValueError)):
        tile_topk(d, lo, bd, bi, k)


def _planted(rng, Q, n, D):
    """Queries and rows of small integers, so every distance is an exact
    f32 integer and ties abound; row copies spread over the tiles plant
    ties at a tile's k-th place and across tiles."""
    x = rng.integers(-2, 3, size=(n, D)).astype(np.float32)
    q = rng.integers(-2, 3, size=(Q, D)).astype(np.float32)
    for src in rng.integers(0, n, size=n // 8):
        x[rng.integers(0, n, size=3)] = x[src]
    return q, x


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("masked", [False, True])
def test_exact_scan_equals_jax(k, masked):
    """``exact_topk`` in tiles of 128 rows (256 at MAX_K, since the JAX
    package selects no more than a tile's rows), a ragged last tile of 41,
    narrower than k from 128 up, with and without masked rows: the same
    ids as the JAX package's ``exact_topk``, ties included, and the same
    distances."""
    from alayalite_tpu.ops.distance import exact_topk as jax_exact_topk

    rng = np.random.default_rng(k * 7 + masked)
    tile = max(128, k)
    q, x = _planted(rng, 24, 3 * tile + 41, 6)
    valid = rng.random(x.shape[0]) > 0.3 if masked else None
    d, i = distance.exact_topk(
        torch.from_numpy(q), torch.from_numpy(x), k, tile_n=tile,
        valid=None if valid is None else torch.from_numpy(valid))
    jd, ji = jax_exact_topk(q, x, k, valid=valid, tile_n=tile)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(d.numpy(), jd)


def test_exact_scan_merges_every_tile_through_tile_topk():
    rng = np.random.default_rng(5)
    q, x = _planted(rng, 10, 1000, 4)
    calls, tiles = tile_topk.calls, distance.counters.tiles
    merges = pool_merge.calls
    distance.exact_topk(torch.from_numpy(q), torch.from_numpy(x), 10,
                        tile_n=128)
    assert tile_topk.calls - calls == distance.counters.tiles - tiles == 8
    assert pool_merge.calls == merges


# ------------------------------------------------------------ on the card
def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _scan_tile(rng, Q, n, dev, ties=True):
    """A tile as the scan makes it: squared L2 distances of normal rows
    (D 128, |x|² ≈ 128), with a share of rows repeated so equal distances
    stand at and around a row's k-th place."""
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    q = torch.randn((Q, 128), device=dev, generator=g)
    x = torch.randn((n, 128), device=dev, generator=g)
    if ties:
        src = torch.randint(0, n, (n // 16,), device=dev, generator=g)
        dst = torch.randint(0, n, (n // 16,), device=dev, generator=g)
        x[dst] = x[src]
    return torch.cdist(q, x).square_().contiguous()


# the flat scan's shapes: a slice of 4,096 and the last of 1,808 against a
# full tile of 16,384 rows and the ragged one of 576 at top 10; fast mode's
# bf16 coarse tile of 65,536 at 40 and calc_gt's at MAX_K; find_medoid's
# one query at 1; and n % 4 != 0, every slot count, k past the tile
CARD_SHAPES = [(4096, 16384, 10), (1808, 16384, 10), (4096, 576, 10),
               (4096, 65536, 40), (4096, 65536, MAX_K), (1, 16384, 1),
               (333, 1001, 33), (257, 4099, 128), (130, 4099, MAX_K),
               (64, 50, MAX_K), (9, 3, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("Q,n,k", CARD_SHAPES)
def test_kernel_matches_plain_version(Q, n, k):
    """Two tiles, as the scan merges them: the first into a running best of
    inf / −1, the second into the first's result; bit for bit."""
    dev = _gpu()
    rng = np.random.default_rng(Q + n + k)
    bd = torch.full((Q, k), float("inf"), device=dev)
    bi = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    for lo in (0, n):
        d = _scan_tile(rng, Q, n, dev)
        want = tile_topk_ref(d.cpu(), lo, bd.cpu(), bi.cpu(), k)
        launches = tile_topk.launches
        tile_topk(d, lo, bd, bi, k)
        torch.cuda.synchronize()
        assert tile_topk.launches == launches + 1
        _same_bits((bd, bi), want)


@pytest.mark.gpu
@pytest.mark.parametrize("Q,n,k", [(512, 2048, 10), (96, 700, 40),
                                   (64, 1024, 128), (40, 1024, MAX_K),
                                   (33, 129, 1)])
def test_kernel_with_ties_specials_and_a_running_best_that_ties(Q, n, k):
    """Quarter-integer tiles with +inf, NaN, −0.0 and −inf, into a running
    best on the same grid that already holds ties with the tile."""
    dev = _gpu()
    rng = np.random.default_rng(Q * 3 + n + k)
    for specials in (False, True):
        for fill in (0.0, 0.6, 1.0):
            d, lo, bd, bi, k = _args(rng, Q, n, k, 7000, specials, fill)
            want = tile_topk_ref(d, lo, bd, bi, k)
            gd, gi = bd.to(dev), bi.to(dev)
            tile_topk(d.to(dev), lo, gd, gi, k)
            torch.cuda.synchronize()
            _same_bits((gd, gi), want)


@pytest.mark.gpu
def test_k_past_max_k_takes_the_wide_route():
    dev = _gpu()
    rng = np.random.default_rng(11)
    k = MAX_K + 1
    bd = torch.full((64, k), float("inf"), device=dev)
    bi = torch.full((64, k), -1, dtype=torch.int32, device=dev)
    d = _scan_tile(rng, 64, 4096, dev, ties=False)
    want = tile_topk_ref(d.cpu(), 0, bd.cpu(), bi.cpu(), k)
    launches, routes = tile_topk.launches, dict(tile_topk.route_calls)
    merges = pool_merge.launches
    tile_topk(d, 0, bd, bi, k)
    torch.cuda.synchronize()
    assert tile_topk.launches == launches
    assert tile_topk.route_calls["wide"] == routes["wide"] + 1
    assert tile_topk.route_calls["kernel"] == routes["kernel"]
    assert pool_merge.launches == merges + 1
    _same_bits((bd, bi), want)


@pytest.mark.gpu
def test_exact_scan_launches_the_kernel_once_a_tile():
    """``exact_topk`` on the card: one ``tile_topk`` launch a tile and no
    merge by ``pool_merge``, the same ids and distances as the scan on the
    CPU."""
    dev = _gpu()
    rng = np.random.default_rng(13)
    q, x = _planted(rng, 300, 40_000, 16)
    valid = torch.from_numpy(rng.random(x.shape[0]) > 0.01)
    launches, merges = tile_topk.launches, pool_merge.launches
    tiles = distance.counters.tiles
    d, i = distance.exact_topk(torch.from_numpy(q).to(dev),
                               torch.from_numpy(x).to(dev), 10,
                               valid=valid.to(dev))
    torch.cuda.synchronize()
    assert tile_topk.launches - launches == distance.counters.tiles - tiles
    assert pool_merge.launches == merges
    wd, wi = distance.exact_topk(torch.from_numpy(q), torch.from_numpy(x),
                                 10, valid=valid)
    _same_bits((d, i), (wd, wi))
