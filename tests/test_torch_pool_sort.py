"""The pool's sort and merge (``ops/pool_sort``): the plain versions against
the TPU prototypes run in interpret mode on the CPU, the merges of
``ops/topk`` against the JAX package's, the wrappers' checks and routing,
and (with a CUDA device) the hand-written kernels.

Every comparison is exact: a sort moves values, it computes none. The
prototypes' bitonic networks are not stable, so against them payloads are
compared exactly on distinct keys, and as multisets per key where keys tie.

JAX is imported inside the tests that use it, so the card's cases run where
JAX is absent: ``python -m pytest --noconftest -m gpu
tests/test_torch_pool_sort.py``."""

import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.ops import topk as ttopk
from alayalite_tpu_torch.ops.pool_sort import (MAX_LIST, WARP_LIST,
                                               WARP_ROLL, merge_kv_ref,
                                               pool_merge, pool_merge_ref,
                                               pool_merge_route, roll_n,
                                               roll_n_ref, roll_n_route,
                                               sort_kv, sort_kv_on,
                                               sort_kv_ref, sort_kv_route)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


def _load_proto(name):
    """A prototype script as a module, unedited; its import-time switch of
    the JAX compilation cache is put back afterwards."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        f"_proto_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert mod.INTERPRET, "the prototypes run in interpret mode on the CPU"
    return mod


@pytest.fixture(scope="module")
def proto():
    return _load_proto("proto_pallas_sort")


@pytest.fixture(scope="module")
def proto2():
    return _load_proto("proto_pallas_sort2")


def _keys(rng, shape, ties: bool):
    keys = rng.normal(size=shape).astype(np.float32)
    if ties:
        keys = np.round(keys * 2.0) / 2.0          # a dozen distinct values
        keys[keys == 0.0] *= rng.choice([-1.0, 1.0], size=(keys == 0).sum())
    return keys


def _same_payloads_per_key(keys, got, want):
    """Payload multisets agree within every run of equal keys."""
    order = np.lexsort((got, keys), axis=-1)
    order_w = np.lexsort((want, keys), axis=-1)
    np.testing.assert_array_equal(np.take_along_axis(got, order, -1),
                                  np.take_along_axis(want, order_w, -1))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("K", [64, 256])
def test_sort_ref_matches_proto_sort_kernel(proto, K, ties):
    import jax
    import jax.numpy as jnp

    B = 64
    rng = np.random.default_rng(K + ties)
    keys = _keys(rng, (B, K), ties)
    pay = rng.integers(0, 1 << 20, size=(B, K)).astype(np.int32)
    ko, po = proto.run("sort", proto.sort_kernel,
                       (jax.ShapeDtypeStruct((B, K), jnp.float32),
                        jax.ShapeDtypeStruct((B, K), jnp.int32)),
                       jnp.asarray(keys), jnp.asarray(pay), grid_bt=32)
    sk, sp = sort_kv_ref(torch.from_numpy(keys), torch.from_numpy(pay))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(ko))
    if ties:
        _same_payloads_per_key(sk.numpy(), sp.numpy(), np.asarray(po))
    else:
        np.testing.assert_array_equal(sp.numpy(), np.asarray(po))


@pytest.mark.parametrize("ties", [False, True])
def test_merge_ref_matches_proto_merge_kernel(proto, ties):
    import jax
    import jax.numpy as jnp

    B, L = 64, 32
    rng = np.random.default_rng(3 + ties)
    ka = np.sort(_keys(rng, (B, L), ties), axis=1)
    kb = np.sort(_keys(rng, (B, L), ties), axis=1)
    pa = rng.integers(0, 1 << 20, size=(B, L)).astype(np.int32)
    pb = rng.integers(0, 1 << 20, size=(B, L)).astype(np.int32)
    km, pm = proto.run("merge", proto.merge_kernel,
                       (jax.ShapeDtypeStruct((B, 2 * L), jnp.float32),
                        jax.ShapeDtypeStruct((B, 2 * L), jnp.int32)),
                       *map(jnp.asarray, (ka, pa, kb, pb)), grid_bt=32)
    sk, sp = merge_kv_ref(*map(torch.from_numpy, (ka, pa, kb, pb)), 2 * L)
    np.testing.assert_array_equal(sk.numpy(), np.asarray(km))
    if ties:
        _same_payloads_per_key(sk.numpy(), sp.numpy(), np.asarray(pm))
    else:
        np.testing.assert_array_equal(sp.numpy(), np.asarray(pm))
    # the merge is the sort of the concatenation, first operand first
    cat = sort_kv_ref(torch.from_numpy(np.concatenate([ka, kb], 1)),
                      torch.from_numpy(np.concatenate([pa, pb], 1)))
    assert torch.equal(sk, cat[0]) and torch.equal(sp, cat[1])


def _special_lists(rng, B, L1, L2):
    """Two ascending operands of a merge, (keys, payload) each, as
    sort_kv_ref orders them: keys on a coarse grid, so they tie within and
    across the operands, both zeros among them, with NaN, +inf and -inf."""
    out = []
    for L in (L1, L2):
        keys = _keys(rng, (B, L), True)
        keys[rng.random((B, L)) < 0.15] = np.inf
        keys[rng.random((B, L)) < 0.05] = -np.inf
        keys[rng.random((B, L)) < 0.05] = np.nan
        pay = rng.integers(-1, 1 << 30, size=(B, L)).astype(np.int32)
        out += sort_kv_ref(torch.from_numpy(keys), torch.from_numpy(pay))
    return out


# the widths tile_topk_ref merges at on the paths: find_medoid's 1 + 1 -> 1,
# the exact flat scan's 10 + 10 -> 10 (k 10) and the fast scan's coarse
# 40 + 40 -> 40
MERGE_KV_PATHS = [(1, 1, 1), (10, 10, 10), (40, 40, 40)]


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("path", MERGE_KV_PATHS)
def test_merge_ref_matches_proto_merge_sorted_at_path_widths(proto, path,
                                                             specials):
    """merge_kv_ref against scripts/proto_pallas_sort.py's merge_sorted (its
    merge_kernel, interpret mode) at the widths the paths merge. The
    network takes two lists of one power-of-two width and compares the
    values it is given, so each operand is handed over as the monotone
    int32 of its keys (the order the merge keeps; NaN after +inf, -0 ==
    +0) padded with the largest int32, the word's position as payload (a's
    i, b's L + j; pads after both). The network is not stable: runs of equal
    keys are put in position order before the first k are taken."""
    import jax
    import jax.numpy as jnp

    L1, L2, k = path
    B, P = 64, 1 << max(0, (L1 - 1).bit_length())
    rng = np.random.default_rng(L1 + 10 * specials)
    if specials:
        ka, pa, kb, pb = (t.numpy() for t in _special_lists(rng, B, L1, L2))
    else:
        ka, pa, kb, pb = (t.numpy() for t in (
            *sort_kv_ref(torch.from_numpy(_keys(rng, (B, L1), True)),
                         torch.from_numpy(rng.integers(0, 99, (B, L1))
                                          .astype(np.int32))),
            *sort_kv_ref(torch.from_numpy(_keys(rng, (B, L2), True)),
                         torch.from_numpy(rng.integers(0, 99, (B, L2))
                                          .astype(np.int32)))))
    big = np.iinfo(np.int32).max
    enc = [np.full((B, P), big, np.int32) for _ in range(2)]
    pos = [np.broadcast_to(np.arange(P, dtype=np.int32) + off, (B, P)).copy()
           for off in (0, L1)]
    for e, p_, keys, L in ((enc[0], pos[0], ka, L1), (enc[1], pos[1], kb, L2)):
        e[:, :L] = _monotone_i32(keys)
        p_[:, L:] = 2 * P + np.arange(P - L)          # pads after every word
    km, pm = proto.run("merge", proto.merge_kernel,
                       (jax.ShapeDtypeStruct((B, 2 * P), jnp.int32),
                        jax.ShapeDtypeStruct((B, 2 * P), jnp.int32)),
                       *map(jnp.asarray, (enc[0], pos[0], enc[1], pos[1])),
                       grid_bt=32)
    km, pm = np.asarray(km), np.asarray(pm)
    assert (km[:, 1:] >= km[:, :-1]).all()
    order = np.lexsort((pm, km), axis=-1)            # ties by position
    first = np.take_along_axis(pm, order, -1)[:, :L1 + L2]
    assert (first < L1 + L2).all()
    cat_k = np.concatenate([ka, kb], 1)
    cat_p = np.concatenate([pa, pb], 1)
    rows = np.arange(B)[:, None]
    for kk in sorted({k, L1 + L2}):
        sk, sp = merge_kv_ref(*map(torch.from_numpy, (ka, pa, kb, pb)), kk)
        np.testing.assert_array_equal(
            sk.numpy().view(np.int32), cat_k[rows, first[:, :kk]].view(np.int32))
        np.testing.assert_array_equal(sp.numpy(), cat_p[rows, first[:, :kk]])
    if specials:
        assert np.isnan(cat_k).any() and np.isneginf(cat_k).any()
        assert np.signbit(cat_k[cat_k == 0]).any()


@pytest.mark.parametrize("layout", ["sub", "sub_pack", "lane_pack"])
def test_sort_ref_matches_proto_layouts(proto2, layout):
    """The three layouts of proto_pallas_sort2: lists along columns with a
    payload, along columns keys only (the slot index packed into the low
    mantissa bits of positive keys), along rows keys only."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    K, B, BT = 64, 256, 128
    rng = np.random.default_rng(7)
    keys = rng.normal(size=(K, B)).astype(np.float32)

    def col(_=None):
        return pl.BlockSpec((K, BT), lambda i: (0, i),
                            memory_space=pltpu.VMEM)

    if layout == "sub":
        pay = rng.integers(0, 1 << 20, size=(K, B)).astype(np.int32)
        f = proto2.pcall(proto2.sort_sub_kernel,
                         (jax.ShapeDtypeStruct((K, B), jnp.float32),
                          jax.ShapeDtypeStruct((K, B), jnp.int32)),
                         (B // BT,), [col(), col()], (col(), col()))
        ko, po = f(jnp.asarray(keys), jnp.asarray(pay))
        sk, sp = sort_kv_ref(torch.from_numpy(keys), torch.from_numpy(pay),
                             axis=0)
        np.testing.assert_array_equal(sk.numpy(), np.asarray(ko))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(po))
        return
    bits = (keys.view(np.int32) & ~np.int32(0xFF)) | np.arange(
        K, dtype=np.int32)[:, None]
    packed = np.abs(bits.view(np.float32))
    if layout == "sub_pack":
        f = proto2.pcall(proto2.sort_sub_pack_kernel,
                         jax.ShapeDtypeStruct((K, B), jnp.float32),
                         (B // BT,), [col()], col())
        ko = f(jnp.asarray(packed))
        sk, none = sort_kv_ref(torch.from_numpy(packed), axis=0)
    else:
        rows = np.ascontiguousarray(packed.T)
        row = pl.BlockSpec((BT, K), lambda i: (i, 0), memory_space=pltpu.VMEM)
        f = proto2.pcall(proto2.sort_lane_pack_kernel,
                         jax.ShapeDtypeStruct((B, K), jnp.float32),
                         (B // BT,), [row], row)
        ko = f(jnp.asarray(rows))
        sk, none = sort_kv_ref(torch.from_numpy(rows), axis=1)
    assert none is None
    np.testing.assert_array_equal(sk.numpy(), np.asarray(ko))


def _monotone_i32(keys):
    """The total order sort_kv sorts by, as an int32 whose signed order is
    it: the key's bits made monotone, −0 == +0, every NaN after +inf."""
    b = keys.view(np.uint32).copy()
    b[np.isnan(keys)] = 0xFFFFFFFF
    b[b == 0x80000000] = 0
    nan = b == 0xFFFFFFFF
    u = np.where(b & 0x80000000, ~b, b | 0x80000000)
    u[nan] = 0xFFFFFFFF
    return (u ^ np.uint32(0x80000000)).view(np.int32)


# (K, k): NN-Descent's join ([rows, 32 + 148] -> 32) and the search's final
# k ([rows, ef 64] -> 10)
TOPK_PATHS = [(180, 32), (64, 10)]


@pytest.mark.parametrize("path", TOPK_PATHS)
def test_sort_ref_matches_proto_at_k_below_K(proto, path):
    """The first k of sort_kv_ref (keys bit for bit, payloads, positions)
    against scripts/proto_pallas_sort.py's sort_kernel in interpret mode on
    keys with NaN, both zeros, +inf and ties. The prototype's network
    compares floats, which leaves a NaN where it is, so it is handed the
    order sort_kv sorts by (the monotone int32 of each key) with the
    position as payload, the row padded to a power of two with the largest
    key; its network is not stable, so runs of equal keys are put in
    position order before the first k are taken."""
    import jax
    import jax.numpy as jnp

    K, k = path
    B, P = 64, 1 << (K - 1).bit_length()
    rng = np.random.default_rng(K + k)
    keys = _keys(rng, (B, K), True)
    keys[rng.random((B, K)) < 0.15] = np.inf
    keys[rng.random((B, K)) < 0.05] = np.nan
    keys[:, :4] = (0.0, -0.0, np.nan, np.inf)
    keys[:4, 4:12] = -0.0                       # ties across the k-th place
    pay = rng.integers(-1, 1 << 30, size=(B, K)).astype(np.int32)
    enc = np.full((B, P), np.iinfo(np.int32).max, np.int32)
    enc[:, :K] = _monotone_i32(keys)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P)).copy()
    ko, po = proto.run("sort", proto.sort_kernel,
                       (jax.ShapeDtypeStruct((B, P), jnp.int32),
                        jax.ShapeDtypeStruct((B, P), jnp.int32)),
                       jnp.asarray(enc), jnp.asarray(pos), grid_bt=32)
    ko, po = np.asarray(ko), np.asarray(po)
    assert (np.diff(ko, axis=1) >= 0).all()
    order = np.lexsort((po, ko), axis=-1)        # ties by position
    first = np.take_along_axis(po, order, -1)[:, :k].astype(np.int64)
    sk, sp, idx = sort_kv_ref(torch.from_numpy(keys), torch.from_numpy(pay),
                              k, 1, True)
    np.testing.assert_array_equal(idx.numpy(), first)
    rows = np.arange(B)[:, None]
    np.testing.assert_array_equal(sk.numpy().view(np.int32),
                                  keys[rows, first].view(np.int32))
    np.testing.assert_array_equal(sp.numpy(), pay[rows, first])
    assert np.isnan(keys).any() and np.signbit(sk.numpy()[:4, :k]).any()
    got = sort_kv(torch.from_numpy(keys), torch.from_numpy(pay), k=k,
                  return_index=True)
    assert all(torch.equal(g.view(torch.int32) if g.dtype == torch.float32
                           else g, w.view(torch.int32)
                           if w.dtype == torch.float32 else w)
               for g, w in zip(got, (sk, sp, idx)))


def test_sort_kv_route_by_shape():
    """Lists along rows up to WARP_LIST keys take the warp kernel: every
    path shape (NN-Descent's 180, the search's pool of ef, the hop's 256
    and the fusion index's 512); wider lists and lists along columns take
    the shared-memory network."""
    for K, _ in TOPK_PATHS:
        assert sort_kv_route(K) == "warp"
    for K in (1, 2, 32, 33, 100, 128, 200, 256, 320, WARP_LIST):
        assert sort_kv_route(K) == sort_kv_route(K, 1) == "warp"
    for K in (WARP_LIST + 1, 1000, MAX_LIST):
        assert sort_kv_route(K) == "network"
    for K in (1, 64, 256, WARP_LIST, 1000):
        assert sort_kv_route(K, 0) == "network"
    assert sort_kv_route(0) == "network"        # no list: nothing launches
    assert sort_kv.route_launches.keys() == {"warp", "network"}


def test_sort_kv_counts_no_launch_on_the_cpu():
    rng = np.random.default_rng(2)
    keys = torch.from_numpy(_keys(rng, (6, 180), True))
    routes = dict(sort_kv.route_launches)
    calls, launches = sort_kv.calls, sort_kv.launches
    sort_kv(keys, k=32, return_index=True)
    sort_kv(keys.T.contiguous(), k=32, axis=0)
    assert (sort_kv.calls, sort_kv.launches) == (calls + 2, launches)
    assert sort_kv.route_launches == routes
    with pytest.raises(ValueError):
        sort_kv_on("sideways", keys, None, 4)


@pytest.mark.parametrize("route", ["warp", "network"])
def test_sort_kv_launcher_counts_only_a_launch(route):
    """``sort_kv_on`` counts where it launches: no lists, or k = 0, launch
    nothing and count nothing."""
    keys = torch.from_numpy(_keys(np.random.default_rng(3), (6, 180), True))
    pay = torch.zeros((6, 180), dtype=torch.int32)
    routes = dict(sort_kv.route_launches)
    launches = sort_kv.launches
    for x, p, k in ((keys[:0], pay[:0], 4), (keys, pay, 0), (keys, None, 0)):
        ok, op, oi = sort_kv_on(route, x, p, k, 1, True)
        assert ok.shape == oi.shape == (x.shape[0], k)
        assert (op is None) == (p is None)
    assert sort_kv.launches == launches
    assert sort_kv.route_launches == routes


def _roll_kernel_n():
    """``roll_kernel_n`` cut out of scripts/opt_hop2.py: importing that
    script would run its timing loops."""
    from jax.experimental.pallas import tpu as pltpu

    with open(os.path.join(SCRIPTS, "opt_hop2.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "roll_kernel_n")
    scope = {"pltpu": pltpu}
    exec(compile(ast.Module([fn], []), "opt_hop2.py", "exec"), scope)
    return scope["roll_kernel_n"]


@pytest.mark.parametrize("K", [256, 32, 96, 512])
@pytest.mark.parametrize("n", [36, 144])
@pytest.mark.parametrize("BT", [8, 32])
def test_roll_ref_matches_proto_roll_kernel(n, BT, K):
    """At the calibration's width 256 and at other widths of 32·W words,
    the rows the card's warp route holds in registers."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    B = 64
    x = np.random.default_rng(n).normal(size=(B, K)).astype(np.float32)
    spec = pl.BlockSpec((BT, K), lambda i: (i, 0), memory_space=pltpu.VMEM)
    f = pl.pallas_call(_roll_kernel_n()(n),
                       out_shape=jax.ShapeDtypeStruct((B, K), jnp.float32),
                       grid=(B // BT,), in_specs=[spec], out_specs=spec,
                       interpret=True)
    want = np.asarray(f(jnp.asarray(x)))
    got = roll_n_ref(torch.from_numpy(x), n)
    np.testing.assert_array_equal(got.numpy(), want)
    # n shifts one by one are one shift by their sum
    total = sum(1 + j % 7 for j in range(n))
    np.testing.assert_array_equal(got.numpy(), np.roll(x, total, axis=1))


# --------------------------------------------------- ops/topk against JAX's
# (L1, L2, k): the search's ef 64 + M·R 256, a young pool at the seed merge,
# ef 100 and 200 (no power of two), eps, exact_topk's [Q, k] + [Q, k],
# k below the pool's width (L1 a power of two and not), the fusion
# index's hop (rows of 2R = 64 ids, 8 expanded: 512 candidates), and the
# fast flat scan's coarse [Q, 40] + [Q, 40]
MERGE_SHAPES = [(64, 256, 64), (32, 8, 32), (100, 256, 100), (200, 256, 200),
                (10, 10, 10), (128, 33, 128), (1, 1, 1), (100, 256, 64),
                (48, 256, 32), (64, 512, 64), (40, 40, 40)]


def _pool_rows(seed, B, L1, L2, holes=False):
    """A pool and candidates with what the hop really holds: ties between
    the operands, duplicate (distance, id) candidates, +inf / −1 slots,
    both zeros, negative keys (IP), ids near 2³⁰. With ``holes`` the pool
    is what a dedup merge leaves: (inf, −1, True) slots inside it, finite
    entries after them (so it is not ascending), and candidates that repeat
    pool entries (equal keys, and equal ids too)."""
    rng = np.random.default_rng(seed)
    d1 = np.sort(np.round(rng.normal(size=(B, L1)) * 4) / 4, axis=1)
    d2 = np.round(rng.normal(size=(B, L2)) * 4) / 4
    d1, d2 = d1.astype(np.float32), d2.astype(np.float32)
    d1[d1 == 0] *= rng.choice([-1.0, 1.0], size=(d1 == 0).sum())
    i1 = rng.integers(0, 50, size=(B, L1)).astype(np.int32)
    i2 = rng.integers(-1, 50, size=(B, L2)).astype(np.int32)
    i1[:, :1] = (1 << 30) - 1 - rng.integers(0, 3, size=(B, 1))
    h = L2 // 2
    d2[:, h:2 * h] = d2[:, :h]                    # duplicates: same (d, id)
    i2[:, h:2 * h] = i2[:, :h]
    d2[i2 < 0] = np.inf
    tail = max(1, L1 // 3)
    d1[:, -tail:] = np.inf                        # a young pool's empty slots
    i1[:, -tail:] = -1
    f1 = rng.random(size=(B, L1)) < 0.5
    f2 = np.zeros((B, L2), bool)
    if holes:
        finite = max(0, L1 - tail)
        hole = np.zeros((B, L1), bool)
        hole[:, :finite] = rng.random(size=(B, finite)) < 0.25
        hole[:, :1] = False           # a finite entry comes after every hole
        d1[hole], i1[hole], f1[hole] = np.inf, -1, True
        if finite:
            rep = rng.integers(0, finite, size=(B, L2 // 4))
            rows = np.arange(B)[:, None]
            d2[:, :L2 // 4] = d1[rows, rep]      # equal keys across operands
            same = rng.random(size=rep.shape) < 0.5
            i2[:, :L2 // 4] = np.where(same, i1[rows, rep], i2[:, :L2 // 4])
    return d1, i1, f1, d2, i2, f2


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("fn", ["merge_topk", "merge_topk_with_flags",
                                "merge_topk_dedup"])
@pytest.mark.parametrize("shape", MERGE_SHAPES)
def test_merges_match_jax_on_pool_rows(fn, shape, holes):
    import jax.numpy as jnp

    from alayalite_tpu.ops import topk as jtopk

    L1, L2, k = shape
    args = _pool_rows(sum(shape), 37, L1, L2, holes)
    if holes and L1 - max(1, L1 // 3) > 1:
        d1 = args[0]
        assert (~np.isfinite(d1[:, :-1]) & np.isfinite(d1[:, 1:])).any(), \
            "the pool rows must hold finite entries after a hole"
    if fn == "merge_topk":
        args = (args[0], args[1], args[3], args[4])
    want = getattr(jtopk, fn)(*map(jnp.asarray, args), k)
    calls = pool_merge.calls
    got = getattr(ttopk, fn)(*map(torch.from_numpy, args), k)
    assert pool_merge.calls == calls + 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 10, 77])
def test_topk_smallest_matches_lax_top_k(k):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(k)
    # + 0.0 turns the rounding's −0.0 into +0.0: lax.top_k orders the two
    # zeros by their sign bit, a stable sort by position
    d = (np.round(rng.normal(size=(29, 77)) * 2) / 2 + 0.0).astype(np.float32)
    d[:, ::7] = np.inf
    nd, sel = jax.lax.top_k(-jnp.asarray(d), k)
    calls = sort_kv.calls
    vals, idx = ttopk.topk_smallest(torch.from_numpy(d), k)
    assert sort_kv.calls == calls + 1 and idx.dtype == torch.int64
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(nd))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(sel))
    v3, i3 = ttopk.topk_smallest(torch.from_numpy(d).view(1, 29, 77), k)
    assert torch.equal(v3[0], vals) and torch.equal(i3[0], idx)


def test_zeros_tie_and_keep_their_bits():
    """−0.0 and +0.0 are one key (max(·, 0) gives +0, an IP distance can
    give −0): position decides between them, and each keeps its sign bit."""
    d1 = torch.tensor([[-1.0, 0.0, -0.0, 2.0]])
    d2 = torch.tensor([[-0.0, 0.0, 1.0]])
    i1 = torch.tensor([[10, 11, 12, 13]], dtype=torch.int32)
    i2 = torch.tensor([[20, 21, 22]], dtype=torch.int32)
    sd, ids = ttopk.merge_topk(d1, i1, d2, i2, 6)
    assert ids.tolist() == [[10, 11, 12, 20, 21, 22]]
    assert torch.signbit(sd).tolist() == [[True, False, True, True, False,
                                           False]]


def test_nan_keys_sort_last():
    keys = torch.tensor([[float("nan"), 1.0, float("inf"), -1.0,
                          float("nan"), float("-inf")]])
    pay = torch.arange(6, dtype=torch.int32)[None]
    sk, sp, idx = sort_kv(keys, pay, return_index=True)
    assert sp.tolist() == [[5, 3, 1, 2, 0, 4]] and idx.tolist() == sp.tolist()
    assert torch.isnan(sk[0, 4:]).all()


def test_cpu_wrappers_run_plain_versions_and_count_calls():
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(_keys(rng, (9, 77), True))
    pay = torch.from_numpy(rng.integers(0, 99, (9, 77)).astype(np.int32))
    for fn, args, ref in [
            (sort_kv, (keys, pay, 10), sort_kv_ref),
            (pool_merge, (keys, pay, pay > 50, keys, pay, pay < 9, 20, True),
             pool_merge_ref),
            (roll_n, (keys, 5), roll_n_ref)]:
        calls, launches = fn.calls, fn.launches
        got, want = fn(*args), ref(*args)
        assert (fn.calls, fn.launches) == (calls + 1, launches)
        got, want = ((got,), (want,)) if fn is roll_n else (got, want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # column layout: the transposed problem
    sk, sp = sort_kv(keys.T.contiguous(), pay.T.contiguous(), k=10, axis=0)
    rk, rp = sort_kv(keys, pay, k=10)
    assert torch.equal(sk, rk.T) and torch.equal(sp, rp.T)
    # k past the width is the whole merge, as the plain version cuts it
    got = pool_merge(keys, pay, None, keys, pay, None, 1000)
    assert got[0].shape == (9, 154) and got[2] is None


def test_pool_merge_route_by_shape():
    """The hop's shapes (ef 32 / 64 / 128 against 256 candidates, the build
    pools' ef 128, the fusion index's 512 candidates) take the warp kernel;
    a list or k past WARP_LIST words takes the shared-memory network."""
    for L1 in (32, 64, 100, 128, 200):
        assert pool_merge_route(L1, 256, L1) == "warp"
        assert pool_merge_route(L1, 512, L1) == "warp"
    assert pool_merge_route(WARP_LIST, WARP_LIST, WARP_LIST) == "warp"
    assert pool_merge_route(WARP_LIST + 1, 1, 1) == "network"
    assert pool_merge_route(1, WARP_LIST + 1, 1) == "network"
    assert pool_merge_route(700, 900, 1600) == "network"


def test_roll_n_route_by_shape():
    """Rows of 32·W words up to WARP_ROLL take the warp kernel; any other
    width the shared-memory one."""
    for K in (32, 96, 256, WARP_ROLL):
        assert roll_n_route(K) == "warp"
    for K in (1, 31, 77, 200, WARP_ROLL + 32, 5000):
        assert roll_n_route(K) == "shared"


@pytest.mark.parametrize("case", ["keys_dtype", "payload_dtype",
                                  "payload_shape", "not_contiguous", "k",
                                  "axis", "too_wide", "rows_differ",
                                  "one_flag", "dedup_without_flags",
                                  "flag_dtype", "roll_n", "roll_dtype"])
def test_wrappers_reject_bad_inputs(case):
    keys = torch.zeros((4, 8))
    pay = torch.zeros((4, 8), dtype=torch.int32)
    flag = torch.zeros((4, 8), dtype=torch.bool)
    bad = {
        "keys_dtype": (TypeError, lambda: sort_kv(keys.double(), pay)),
        "payload_dtype": (TypeError, lambda: sort_kv(keys, pay.long())),
        "payload_shape": (TypeError, lambda: sort_kv(keys, pay[:, :4]
                                                     .contiguous())),
        "not_contiguous": (ValueError, lambda: sort_kv(keys[:, ::2])),
        "k": (ValueError, lambda: sort_kv(keys, pay, k=9)),
        "axis": (ValueError, lambda: sort_kv(keys, pay, axis=2)),
        "too_wide": (ValueError,
                     lambda: sort_kv(torch.zeros((1, MAX_LIST + 1)))),
        "rows_differ": (TypeError,
                        lambda: pool_merge(keys, pay, None, keys[:2],
                                           pay[:2], None, 4)),
        "one_flag": (TypeError,
                     lambda: pool_merge(keys, pay, flag, keys, pay, None, 4)),
        "dedup_without_flags": (ValueError, lambda: pool_merge(
            keys, pay, None, keys, pay, None, 4, dedup=True)),
        "flag_dtype": (TypeError, lambda: pool_merge(
            keys, pay, pay, keys, pay, pay, 4)),
        "roll_n": (ValueError, lambda: roll_n(keys, -1)),
        "roll_dtype": (TypeError, lambda: roll_n(pay, 3)),
    }
    err, call = bad[case]
    with pytest.raises(err):
        call()


# ------------------------------------------------------------- on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _equal(got, want, what):
    for g, w in zip(got, want):
        if w is None:
            assert g is None, what
            continue
        same = (torch.equal(g, w) if g.dtype != torch.float32 else
                torch.equal(g.view(torch.int32), w.view(torch.int32)))
        assert same, what


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 2, 77, 200, 256, 320, 1000, 5000])
@pytest.mark.parametrize("B", [1, 333, 1000])
def test_cuda_sort_kv_matches_plain_version(B, K):
    _need_cuda()
    rng = np.random.default_rng(B + K)
    keys = _keys(rng, (B, K), True)
    keys[rng.random((B, K)) < 0.2] = np.inf
    keys[rng.random((B, K)) < 0.01] = np.nan
    keys = torch.from_numpy(keys).cuda()
    pay = torch.from_numpy(rng.integers(-1, 1 << 30, (B, K))
                           .astype(np.int32)).cuda()
    for k in (K, max(1, K // 3)):
        launches = sort_kv.launches
        got = sort_kv(keys, pay, k=k, return_index=True)
        torch.cuda.synchronize()
        assert sort_kv.launches == launches + 1
        _equal(got, sort_kv_ref(keys, pay, k, 1, True), (B, K, k))
        _equal(sort_kv(keys, k=k), sort_kv_ref(keys, None, k), (B, K, k))
        kt, pt = keys.T.contiguous(), pay.T.contiguous()
        _equal(sort_kv(kt, pt, k=k, axis=0), sort_kv_ref(kt, pt, k, 0),
               (B, K, k, "columns"))


@pytest.mark.gpu
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("shape", MERGE_SHAPES + [(0, 5, 3), (100, 256, 356),
                                                  (1, 200, 1), (1, 200, 201),
                                                  (300, 400, 300),
                                                  (512, 512, 512),
                                                  (513, 64, 64),
                                                  (700, 900, 1600),
                                                  (300, 1024, 500),
                                                  (64, 2000, 64)])
@pytest.mark.parametrize("B", [1, 333, 4096])
def test_cuda_merges_match_plain_versions(B, shape, holes):
    """Both kernels of pool_merge: the warp route up to WARP_LIST words a
    list and k (its two instances: up to 8 and up to 16 words a lane), the
    shared-memory network past it (the last four shapes); with and without
    flags."""
    _need_cuda()
    L1, L2, k = shape
    d1, i1, f1, d2, i2, f2 = (torch.from_numpy(a).cuda()
                              for a in _pool_rows(B + sum(shape), B, L1, L2,
                                                  holes))
    route = pool_merge_route(L1, L2, min(k, L1 + L2))
    for dedup in (False, True):
        launches = pool_merge.launches
        by_route = pool_merge.route_launches[route]
        got = pool_merge(d1, i1, f1, d2, i2, f2, k, dedup)
        torch.cuda.synchronize()
        assert pool_merge.launches == launches + 1
        assert pool_merge.route_launches[route] == by_route + 1
        _equal(got, pool_merge_ref(d1, i1, f1, d2, i2, f2, k, dedup),
               (B, shape, dedup))
    _equal(pool_merge(d1, i1, None, d2, i2, None, k),
           pool_merge_ref(d1, i1, None, d2, i2, None, k), (B, shape))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 10, 10, 10), (4096, 40, 40, 40),
                                   (1, 1, 1, 1), (1, 1, 200, 1),
                                   (1, 1, 200, 201), (4096, 64, 64, 128),
                                   (333, 100, 7, 50), (333, 7, 100, 107),
                                   (9, 5000, 3000, 8000), (9, 0, 33, 20)])
def test_cuda_pool_merge_on_special_keys(shape):
    """pool_merge without flags (``merge_topk``, tile_topk's wide route) bit
    for bit against its plain version on keys with NaN, both zeros, +-inf
    and ties within and across the operands, at the flat scans' widths and
    at ragged, wide and one-sided ones; one launch a call."""
    _need_cuda()
    B, L1, L2, k = shape
    a_k, a_p, b_k, b_p = (t.cuda() for t in _special_lists(
        np.random.default_rng(B + L1 + L2), B, L1, L2))
    launches = pool_merge.launches
    got = pool_merge(a_k, a_p, None, b_k, b_p, None, k)
    torch.cuda.synchronize()
    assert pool_merge.launches == launches + 1
    _equal(got, pool_merge_ref(a_k, a_p, None, b_k, b_p, None, k), shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 256), (333, 77), (1, 1), (5, 5000),
                                   (1000, 32), (333, 512), (7, 96),
                                   (4097, 256)])
def test_cuda_roll_n_matches_torch_roll(shape):
    """Bit for bit on both kernels; the launches by kernel add up to the
    launches."""
    _need_cuda()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape)
                         .astype(np.float32)).cuda()
    route = roll_n_route(shape[1])
    for n in (0, 1, 36, 144):
        launches, routes = roll_n.launches, dict(roll_n.route_launches)
        got = roll_n(x, n)
        torch.cuda.synchronize()
        assert roll_n.launches == launches + 1
        assert roll_n.route_launches[route] == routes[route] + 1
        assert sum(roll_n.route_launches.values()) - sum(routes.values()) == 1
        assert torch.equal(got.view(torch.int32),
                           roll_n_ref(x, n).view(torch.int32)), (shape, n)


@pytest.mark.gpu
def test_cuda_hop_merge_runs_the_kernel_and_no_torch_sort(monkeypatch):
    """``merge_topk_dedup`` and ``topk_smallest`` on CUDA tensors launch the
    hand-written kernels; ``torch.sort`` is never reached."""
    _need_cuda()
    args = [torch.from_numpy(a).cuda() for a in _pool_rows(5, 4096, 64, 256)]
    want = pool_merge_ref(*args, 64, True)
    want_top = sort_kv_ref(args[3], None, 10, 1, True)

    def no_sort(*a, **kw):
        raise AssertionError("torch.sort reached from the hop's merge")

    monkeypatch.setattr(torch, "sort", no_sort)
    launches = pool_merge.launches, sort_kv.launches
    got = ttopk.merge_topk_dedup(*args, 64)
    vals, idx = ttopk.topk_smallest(args[3], 10)
    torch.cuda.synchronize()
    assert (pool_merge.launches, sort_kv.launches) == (launches[0] + 1,
                                                       launches[1] + 1)
    _equal(got, want, "merge_topk_dedup")
    _equal((vals, idx), (want_top[0], want_top[2]), "topk_smallest")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 256, 256), (4096, 180, 32),
                                   (4096, 64, 10), (333, 512, 512),
                                   (333, 512, 7), (1000, 77, 77),
                                   (1000, 33, 5), (7, 1, 1), (9, 2, 1),
                                   (4097, 320, 100)])
def test_cuda_sort_kv_warp_route_matches_network_and_plain(shape):
    """The warp kernel against the shared-memory network and the plain
    version, bit for bit (keys, payloads, positions), on keys with NaN, both
    zeros, +inf and ties, with and without payload, on aligned rows and on
    rows one word past a 16-byte boundary (no vector loads); the wrapper
    counts the launch under "warp"."""
    _need_cuda()
    B, K, k = shape
    rng = np.random.default_rng(B + K + k)
    keys = _keys(rng, (B, K), True)
    keys[rng.random((B, K)) < 0.2] = np.inf
    keys[rng.random((B, K)) < 0.02] = np.nan
    keys = torch.from_numpy(keys).cuda()
    flat = torch.empty(keys.numel() + 1, dtype=torch.float32, device="cuda")
    shifted = flat[1:].view(keys.shape).copy_(keys)
    pay = torch.from_numpy(rng.integers(-1, 1 << 30, (B, K))
                           .astype(np.int32)).cuda()
    for p in (pay, None):
        want = sort_kv_ref(keys, p, k, 1, True)
        for x in (keys, shifted):
            for route in ("warp", "network"):
                before = dict(sort_kv.route_launches)
                got = sort_kv_on(route, x, p, k, 1, True, counted=False)
                torch.cuda.synchronize()
                _equal(got, want, (shape, route, p is None))
                assert sort_kv.route_launches == before
    before = sort_kv.route_launches["network"]
    _equal(sort_kv_on("network", keys, pay, k, 1, True),
           sort_kv_ref(keys, pay, k, 1, True), shape)
    assert sort_kv.route_launches["network"] == before + 1
    assert sort_kv_route(K) == "warp"
    before = sort_kv.route_launches["warp"]
    _equal(sort_kv(keys, pay, k=k, return_index=True),
           sort_kv_ref(keys, pay, k, 1, True), shape)
    assert sort_kv.route_launches["warp"] == before + 1
