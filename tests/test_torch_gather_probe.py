"""gather_diagdot, gather_estimate and ring_probe: the port's plain
versions against the JAX functions and the TPU kernels' formulas, the CPU
wrappers' routing and checks, the hop that calls them, and (with a CUDA
device) the hand-written kernels.

Tolerance of gather_diagdot, rtol 1e-5 / atol 1e-3: (c − 128) is exact in
bf16 and every bf16 × bf16 product is exact in f32, so the sides differ
only in the order of the f32 sums. On the card the fused estimate equals
the plain epilogue applied to the same entry's dot bit for bit, and its ids
exactly. ring_probe is exact.

JAX is imported inside the tests that use it, so the card's cases run where
JAX is absent: ``python -m pytest --noconftest -m gpu
tests/test_torch_gather_probe.py``."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.ops.gather_diagdot import (VARIANTS, bulk_fits,
                                                    estimate_epilogue,
                                                    gather_diagdot,
                                                    gather_diagdot_ref,
                                                    gather_estimate,
                                                    gather_estimate_ref)
from alayalite_tpu_torch.ops.ring_probe import (HASH_SEEN, ring_probe,
                                                ring_probe_on, ring_probe_ref,
                                                ring_probe_route)

# (C, R, Dp, B, M); R = 1 is the sq8 traversal's view of its codes
GATHER_SHAPES = [(300, 16, 128, 32, 8), (50, 24, 96, 9, 5), (20, 7, 40, 13, 3),
                 (300, 1, 128, 32, 256), (50, 1, 96, 9, 20)]
# (B, K, S)
PROBE_SHAPES = [(64, 128, 96), (7, 33, 10), (5, 1, 3)]
# the shapes the paths probe at, (K, S, S2), B cut: the bsq8 search at ef 64
# (pop ring 96, pool 64), the build pools at ef 128 and at ef_construction
# 200, the raw ring walk at ef 64 (pop ring alone) and the fusion hop (64
# neighbors of 8 pops)
PATH_PROBES = [(256, 96, 64), (256, 96, 128), (256, 96, 200), (256, 96, 0),
               (512, 96, 0)]
I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _gather_inputs(shape, seed=0):
    C, R, Dp, B, M = shape
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, size=(C, R, Dp), dtype=np.uint8)
    u = rng.integers(0, C, size=(B, M)).astype(np.int32)
    u[0, :] = 0                       # inactive pops are clamped to node 0
    qs = rng.normal(size=(B, Dp)).astype(np.float32)
    return codes, u, qs


def _probe_inputs(shape, seed=0):
    B, K, S = shape
    rng = np.random.default_rng(seed)
    nids = rng.integers(-1, 40, size=(B, K)).astype(np.int32)
    seen = rng.integers(-1, 40, size=(B, S)).astype(np.int32)
    return nids, seen


def _as_torch(codes, u, qs, device="cpu"):
    return (torch.from_numpy(codes).to(device), torch.from_numpy(u).to(device),
            torch.from_numpy(qs).to(torch.bfloat16).to(device))


@pytest.mark.parametrize("against", ["jax_block_diagdot", "dma_formula"])
@pytest.mark.parametrize("shape", GATHER_SHAPES)
def test_gather_ref_matches_jax(shape, against, monkeypatch):
    codes, u, qs = _gather_inputs(shape, seed=sum(shape))
    C, R, Dp, B, M = shape
    got = gather_diagdot_ref(*_as_torch(codes, u, qs)).numpy()
    if against == "jax_block_diagdot":
        import jax.numpy as jnp

        from alayalite_tpu.ops.pallas_block import block_diagdot

        monkeypatch.setenv("ALAYA_PALLAS", "0")
        g = jnp.asarray(codes)[jnp.asarray(u)].reshape(B, M * R, Dp)
        want = np.asarray(block_diagdot(g, jnp.asarray(qs)))
    else:
        # scripts/proto_dma_gather.py: each node's block is copied, decoded
        # to (c − 128), multiplied by the bf16 queries and summed in f32
        q16 = torch.from_numpy(qs).to(torch.bfloat16).float().numpy()
        blocks = codes[u].astype(np.float64) - 128.0        # [B, M, R, Dp]
        want = np.einsum("bmrd,bd->bmr", blocks,
                         q16.astype(np.float64)).reshape(B, M * R)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_probe_ref_matches_tpu_formula(shape):
    nids, seen = _probe_inputs(shape, seed=sum(shape))
    # scripts/proto_pallas_sort2.py ring_probe_kernel on its [K, BT] /
    # [RING, BT] layout: acc |= (nids == ring[j, :][None, :]) for every j
    nt, ring = nids.T, seen.T
    acc = np.zeros(nt.shape, np.int32)
    for j in range(ring.shape[0]):
        acc |= (nt == ring[j][None, :]).astype(np.int32)
    got = ring_probe_ref(torch.from_numpy(nids), torch.from_numpy(seen))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), acc.T.astype(bool))
    # −1 equals −1: the callers mask nids >= 0 afterwards
    pad = ring_probe_ref(torch.tensor([[-1, 3]], dtype=torch.int32),
                         torch.tensor([[5, -1]], dtype=torch.int32))
    assert pad.tolist() == [[True, False]]


def _path_probe_inputs(B, K, S, S2, seed):
    """A hop's operands: a pop ring whose older slots are still −1, a pool
    with an empty (−1) tail, neighbor ids that repeat both and each other,
    inactive pops' −1 ids."""
    rng = np.random.default_rng(seed)
    hi = 3 * (S + S2) + 8
    ring = rng.integers(0, hi, size=(B, S)).astype(np.int32)
    ring[:, : S // 2] = -1
    pool = rng.integers(0, hi, size=(B, S2)).astype(np.int32)
    pool[:, S2 - S2 // 4:] = -1
    nids = rng.integers(-1, hi, size=(B, K)).astype(np.int32)
    nids[:, : K // 8] = nids[:, K // 8: 2 * (K // 8)]
    return nids, ring, pool


def _isin_rows(nids, seen):
    return np.stack([np.isin(n, s) for n, s in zip(nids, seen)])


@pytest.mark.parametrize("path", PATH_PROBES)
def test_probe_ref_matches_proto_kernel_at_path_shapes(path):
    """ring_probe_ref (and the CPU wrapper, with the seen ids as one operand
    or two) against scripts/proto_pallas_sort2.py's ring_probe_kernel run
    through pallas_call in interpret mode, on its [K, BT] / [RING, BT]
    layout, at the paths' widths with B cut to 16."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = importlib.util.spec_from_file_location(
        "_proto_probe", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "proto_pallas_sort2.py"))
    proto2 = importlib.util.module_from_spec(spec)
    before = jax.config.jax_compilation_cache_dir
    try:
        spec.loader.exec_module(proto2)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert proto2.INTERPRET
    K, S, S2 = path
    B, BT = 16, 16
    nids, ring, pool = _path_probe_inputs(B, K, S, S2, seed=K + S + S2)
    seen = np.concatenate([ring, pool], 1)

    def spec_of(rows):
        return pl.BlockSpec((rows, BT), lambda i: (0, i),
                            memory_space=pltpu.VMEM)

    f = proto2.pcall(proto2.ring_probe_kernel,
                     jax.ShapeDtypeStruct((K, B), jnp.int32), (B // BT,),
                     [spec_of(K), spec_of(S + S2)], spec_of(K))
    want = np.asarray(f(jnp.asarray(nids.T.copy()),
                        jnp.asarray(seen.T.copy()))).T.astype(bool)
    assert want.any() and not want.all()
    tn, tr, tp = map(torch.from_numpy, (nids, ring, pool))
    got = ring_probe_ref(tn, tr, tp if S2 else None)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ring_probe(tn, torch.from_numpy(seen)).numpy(), want)
    if S2:
        np.testing.assert_array_equal(ring_probe(tn, tr, tp).numpy(), want)
    assert ring_probe_route(S, S2) == "hash"


def _edge_probe_inputs(case):
    """Operands that break a hash table: the empty-slot marker's candidates
    (INT_MIN, INT_MAX, −1) as ids and as seen entries, a seen row of one id,
    a single seen entry, and a seen width past the hash kernel's."""
    rng = np.random.default_rng(len(case))
    B, K = 9, 40
    nids = rng.integers(-1, 60, size=(B, K)).astype(np.int32)
    if case == "int_extremes":
        seen = rng.integers(0, 60, size=(B, 24)).astype(np.int32)
        nids[:, :3] = (I32_MIN, I32_MAX, -1)
        seen[0::2, :3] = (I32_MIN, I32_MAX, -1)   # members in even rows only
        seen[1::2, :3] = (I32_MIN + 1, I32_MAX - 1, -2)
        return nids, seen[:, :10], seen[:, 10:]
    if case == "one_id_row":
        seen = np.full((B, 64), 7, np.int32)
        seen[1] = -1
        seen[2] = I32_MIN
        nids[:, 0] = (7, -1, I32_MIN, 7, 7, 7, 7, 7, 7)
        return nids, seen[:, :48], seen[:, 48:]
    if case == "s1":
        seen = rng.integers(-1, 4, size=(B, 1)).astype(np.int32)
        return nids, seen, None
    assert case == "past_hash_limit"
    seen = rng.integers(-1, 3 * HASH_SEEN, size=(B, HASH_SEEN + 5)
                        ).astype(np.int32)
    nids = rng.integers(-1, 3 * HASH_SEEN, size=(B, K)).astype(np.int32)
    return nids, seen[:, :1000], seen[:, 1000:]


@pytest.mark.parametrize("case", ["int_extremes", "one_id_row", "s1",
                                  "past_hash_limit"])
def test_probe_ref_on_hash_breaking_ids(case):
    nids, seen, seen2 = _edge_probe_inputs(case)
    full = seen if seen2 is None else np.concatenate([seen, seen2], 1)
    want = _isin_rows(nids, full)
    assert want.any() and not want.all()
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (nids, seen, seen2) if a is not None]
    np.testing.assert_array_equal(ring_probe_ref(*args).numpy(), want)
    np.testing.assert_array_equal(ring_probe(*args).numpy(), want)
    if case == "int_extremes":
        assert want[0::2, :3].all() and not want[1::2, :3].any()
    if case == "one_id_row":    # 7, −1 and INT_MIN each a whole row
        assert want[:, 0].all()
    S2 = 0 if seen2 is None else seen2.shape[1]
    assert ring_probe_route(seen.shape[1], S2) == (
        "scan" if case == "past_hash_limit" else "hash")


def test_probe_second_operand_is_the_concatenation():
    """ring_probe(nids, seen, seen2) on the CPU is ring_probe(nids,
    seen ‖ seen2), at every split of one seen row, empty halves too."""
    nids, ring, pool = _path_probe_inputs(6, 50, 24, 16, seed=4)
    seen = torch.from_numpy(np.concatenate([ring, pool], 1))
    nids = torch.from_numpy(nids)
    whole = ring_probe(nids, seen)
    for cut in (0, 1, 13, 24, 39, 40):
        a, b = seen[:, :cut].contiguous(), seen[:, cut:].contiguous()
        assert torch.equal(ring_probe(nids, a, b), whole), cut
        assert torch.equal(ring_probe_ref(nids, a, b), whole), cut
    assert not ring_probe(nids, seen[:, :0], seen[:, :0]).any()


def test_ring_probe_route_by_width():
    """Every path shape takes the hash kernel; only a seen width past
    HASH_SEEN takes the scan."""
    for _, S, S2 in PATH_PROBES:
        assert ring_probe_route(S, S2) == "hash"
    assert ring_probe_route(96, 200) == "hash"     # ef_construction 200
    assert ring_probe_route(1) == ring_probe_route(0, 0) == "hash"
    assert ring_probe_route(HASH_SEEN) == ring_probe_route(
        HASH_SEEN - 64, 64) == "hash"
    assert ring_probe_route(HASH_SEEN + 1) == "scan"
    assert ring_probe_route(HASH_SEEN, 1) == "scan"
    assert ring_probe.route_launches.keys() == {"hash", "scan"}


def _estimate_inputs(codes, u, seed):
    C, R, _ = codes.shape
    rng = np.random.default_rng(seed)
    qconst = torch.from_numpy(rng.normal(size=u.shape[0]).astype(np.float32)
                              * 50)
    xsq = rng.random((C, R)).astype(np.float32) * 20
    ids = rng.integers(-1, C, size=(C, R)).astype(np.int32)
    xsq[ids < 0] = np.inf                # -1 slots carry |x̂|² = inf
    return qconst, torch.from_numpy(xsq), torch.from_numpy(ids)


def test_cpu_wrappers_run_plain_versions_and_count_calls():
    codes, u, qs = _as_torch(*_gather_inputs(GATHER_SHAPES[1], seed=1))
    est_args = _estimate_inputs(codes, u, seed=1)
    for variant in VARIANTS:
        calls, launches = gather_diagdot.calls, gather_diagdot.launches
        got = gather_diagdot(codes, u, qs, variant=variant)
        assert gather_diagdot.calls == calls + 1
        assert gather_diagdot.launches == launches   # no kernel on the CPU
        assert torch.equal(got, gather_diagdot_ref(codes, u, qs))
        calls, launches = gather_estimate.calls, gather_estimate.launches
        qconst, xsq, ids = est_args
        est, nid = gather_estimate(codes, u, qs, qconst, 2.0, xsq, ids, True,
                                   variant=variant)
        assert (gather_estimate.calls, gather_estimate.launches) == (
            calls + 1, launches)
        want = gather_estimate_ref(codes, u, qs, qconst, 2.0, xsq, ids, True)
        assert torch.equal(est, want[0]) and torch.equal(nid, want[1])
    nids, seen = map(torch.from_numpy, _probe_inputs(PROBE_SHAPES[1], seed=1))
    calls, launches = ring_probe.calls, ring_probe.launches
    got = ring_probe(nids, seen)
    assert (ring_probe.calls, ring_probe.launches) == (calls + 1, launches)
    assert torch.equal(got, ring_probe_ref(nids, seen))
    assert not ring_probe(nids, seen[:, :0]).any()


def test_gather_wrapper_rejects_bad_inputs():
    codes, u, qs = _as_torch(*_gather_inputs(GATHER_SHAPES[2], seed=2))
    with pytest.raises(TypeError):
        gather_diagdot(codes.to(torch.int16), u, qs)
    with pytest.raises(TypeError):
        gather_diagdot(codes, u.long(), qs)
    with pytest.raises(TypeError):
        gather_diagdot(codes, u, qs.float())
    with pytest.raises(TypeError):
        gather_diagdot(codes, u, qs[:3])
    with pytest.raises(ValueError):
        gather_diagdot(codes, u.T.contiguous().T, qs)
    with pytest.raises(ValueError):
        gather_diagdot(codes, u, qs, variant="tiled")
    with pytest.raises(ValueError):
        gather_diagdot(codes[:0], u, qs)
    qconst, xsq, ids = _estimate_inputs(codes, u, seed=2)
    with pytest.raises(TypeError):
        gather_estimate(codes, u, qs, qconst[:2], 2.0, xsq, ids, True)
    with pytest.raises(TypeError):
        gather_estimate(codes, u, qs, qconst, 2.0, xsq.double(), ids, True)
    with pytest.raises(TypeError):
        gather_estimate(codes, u, qs, qconst, 2.0, xsq, ids.long(), True)
    with pytest.raises(ValueError):
        gather_estimate(codes, u, qs, qconst, 2.0, xsq.T.contiguous().T, ids,
                        True)
    with pytest.raises(ValueError):
        gather_estimate(codes, u, qs, qconst, 2.0, xsq, ids, True,
                        variant="staged")


def test_probe_wrapper_rejects_bad_inputs():
    nids, seen = map(torch.from_numpy, _probe_inputs(PROBE_SHAPES[0], seed=3))
    with pytest.raises(TypeError):
        ring_probe(nids.long(), seen)
    with pytest.raises(TypeError):
        ring_probe(nids, seen.long())
    with pytest.raises(TypeError):
        ring_probe(nids, seen[:5])
    with pytest.raises(ValueError):
        ring_probe(nids[:, ::2], seen)


def test_probe_wrapper_rejects_bad_second_operand():
    nids, ring, pool = map(torch.from_numpy,
                           _path_probe_inputs(4, 16, 8, 8, seed=5))
    with pytest.raises(TypeError):
        ring_probe(nids, ring, pool.long())
    with pytest.raises(TypeError):
        ring_probe(nids, ring, pool[:3])
    with pytest.raises(TypeError):
        ring_probe(nids, ring, pool[0])
    with pytest.raises(ValueError):
        ring_probe(nids, ring, pool[:, ::2])
    with pytest.raises(ValueError):
        ring_probe(nids, ring, torch.zeros((4, 60_000), dtype=torch.int32))
    with pytest.raises(ValueError):
        ring_probe_on("sideways", nids, ring, pool)


def test_probe_counts_no_launch_on_the_cpu():
    nids, ring, pool = map(torch.from_numpy,
                           _path_probe_inputs(4, 16, 8, 8, seed=6))
    routes = dict(ring_probe.route_launches)
    calls, launches = ring_probe.calls, ring_probe.launches
    ring_probe(nids, ring, pool)
    ring_probe(nids, ring)
    assert (ring_probe.calls, ring_probe.launches) == (calls + 2, launches)
    assert ring_probe.route_launches == routes


@pytest.mark.parametrize("route", ["hash", "scan"])
def test_probe_launcher_counts_only_a_launch(route):
    """``ring_probe_on`` counts where it launches: no ids, or no seen ids,
    launch nothing and count nothing."""
    nids, ring, pool = map(torch.from_numpy,
                           _path_probe_inputs(4, 16, 8, 8, seed=7))
    routes = dict(ring_probe.route_launches)
    launches = ring_probe.launches
    for args in ((nids[:0], ring[:0], pool[:0]), (nids, ring[:, :0], None),
                 (nids, ring[:, :0], pool[:, :0])):
        out = ring_probe_on(route, *args)
        assert out.dtype == torch.bool and out.shape == args[0].shape
        assert not out.any()
    assert ring_probe.launches == launches
    assert ring_probe.route_launches == routes


@pytest.mark.parametrize("pops", ["random", "inactive_on_node0"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_estimate_many_matches_jax_and_estimate_for(metric, pops):
    """``BQGSpace.estimate_many`` (``gather_estimate``) and the fused entry's
    plain version ``gather_estimate_ref`` against the JAX space on the same
    rows and adjacency (−1 neighbor slots among them, and with
    ``inactive_on_node0`` a quarter of the queries popping node 0 only, as
    the hop's inactive pops do), and against the port's own one-node
    ``estimate_for`` (block_diagdot). rtol 1e-4 / atol 1e-2: one ulp of the
    f32 estimate near |q|² + |x̂|² ~ 500."""
    import jax.numpy as jnp

    from alayalite_tpu.spaces.bqg import BQGSpace as JaxBQG
    from alayalite_tpu_torch.spaces.bqg import BQGSpace

    n, dim, r, B, M = 400, 32, 16, 24, 4
    rng = np.random.default_rng(5)
    data = (rng.normal(size=(n, dim)) * 3.0).astype(np.float32)
    nbrs = rng.integers(-1, n, size=(n, r)).astype(np.int32)
    q = rng.normal(size=(B, dim)).astype(np.float32)
    u = rng.integers(0, n, size=(B, M)).astype(np.int32)
    if pops == "inactive_on_node0":
        u[: B // 4] = 0
    jsp = JaxBQG.create(n, dim, metric=metric, degree=r).fit(jnp.asarray(data))
    jsp = jsp.update_neighbors(nbrs)
    jest, jids = jsp.estimate_many(jsp.query_ctx(jnp.asarray(q)),
                                   jnp.asarray(u))
    sp = BQGSpace.create(n, dim, metric=metric, degree=r).fit(
        torch.from_numpy(data))
    sp.update_neighbors(torch.from_numpy(nbrs))
    ctx = sp.query_ctx(torch.from_numpy(q))
    calls = gather_estimate.calls
    est, ids = sp.estimate_many(ctx, torch.from_numpy(u))
    assert gather_estimate.calls == calls + 1
    ref = gather_estimate_ref(sp.nbr_codes, torch.from_numpy(u), ctx[1],
                              ctx[2], sp._dot_coef, sp.nbr_xsq, sp.nbr_ids,
                              metric == "l2")
    assert (ids == -1).any() and torch.isinf(est[ids == -1]).all()
    for e, i in ((est, ids), ref):
        np.testing.assert_array_equal(i.numpy(), np.asarray(jids))
        np.testing.assert_allclose(e.numpy(), np.asarray(jest), rtol=1e-4,
                                   atol=1e-2)
    for m in range(M):
        e1, i1 = sp.estimate_for(ctx, torch.from_numpy(u[:, m]))
        assert torch.equal(i1, ids[:, m * r:(m + 1) * r])
        np.testing.assert_allclose(e1.numpy(),
                                   est[:, m * r:(m + 1) * r].numpy(),
                                   rtol=1e-6, atol=1e-4)


def test_hop_goes_through_both_wrappers():
    """One block search calls gather_estimate and ring_probe once per hop;
    one raw beam search calls ring_probe once per expansion."""
    from alayalite_tpu_torch.index.search import beam_search, block_beam_search
    from alayalite_tpu_torch.spaces.bqg import BQGSpace
    from alayalite_tpu_torch.spaces.raw import RawSpace

    n, dim, r = 300, 16, 8
    rng = np.random.default_rng(9)
    data = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
    nbrs = torch.from_numpy(rng.integers(0, n, size=(n, r)).astype(np.int32))
    sp = BQGSpace.create(n, dim, degree=r).fit(data)
    sp.update_neighbors(nbrs)
    q = data[:6] + 0.01
    seeds = torch.arange(6, dtype=torch.int32)[:, None]   # each row's own node
    g, p = gather_estimate.calls, ring_probe.calls
    d, i = block_beam_search(sp, seeds, q, k=5, ef=16, n_expand=2)
    hops = gather_estimate.calls - g
    assert hops > 0 and ring_probe.calls - p == hops
    assert (i[:, 0] == torch.arange(6)).all() and torch.isfinite(d).all()
    raw = RawSpace.create(n, dim).fit(data)
    p = ring_probe.calls
    d2, i2 = beam_search(raw, nbrs, seeds, q, k=5, ef=16, n_expand=2)
    assert ring_probe.calls - p >= 2
    assert (i2[:, 0] == torch.arange(6)).all()


def test_block_hop_passes_pop_ring_and_pool_apart(monkeypatch):
    """The block hop hands ring_probe its pop ring and its pool as two
    operands, the pool as the merge returned it: it concatenates nothing
    for the stale check."""
    from alayalite_tpu_torch.index import search
    from alayalite_tpu_torch.spaces.bqg import BQGSpace

    n, dim, r = 200, 16, 8
    rng = np.random.default_rng(10)
    data = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
    nbrs = torch.from_numpy(rng.integers(0, n, size=(n, r)).astype(np.int32))
    sp = BQGSpace.create(n, dim, degree=r).fit(data)
    sp.update_neighbors(nbrs)
    seen_args = []

    def probe(nids, seen, seen2=None):
        seen_args.append((seen.shape, None if seen2 is None else seen2.shape))
        return ring_probe(nids, seen, seen2)

    monkeypatch.setattr(search, "ring_probe", probe)
    q = data[:5] + 0.01
    seeds = torch.arange(5, dtype=torch.int32)[:, None]
    ef, m = 16, 2
    d, i = search.block_beam_search(sp, seeds, q, k=5, ef=ef, n_expand=m)
    ring_w = search._popring_width(m, search._default_iters(ef, m, 0))
    assert seen_args and all(a == ((5, ring_w), (5, ef)) for a in seen_args)
    assert (i[:, 0] == torch.arange(5)).all()


# the hop's shape, the sq8 traversal's (R = 1), ragged ones, Dp % 16 != 0
GPU_GATHER_SHAPES = GATHER_SHAPES + [
    (5000, 24, 96, 1000, 5), (900, 7, 40, 333, 3), (100_000, 32, 128, 4096, 8),
    (100_000, 1, 128, 4096, 256), (5000, 1, 100, 333, 77),
    (2000, 4, 960, 64, 9), (3000, 2, 2048, 16, 3)]


def _unaligned(codes):
    """The same codes at a base one byte past a 16-byte boundary."""
    flat = torch.empty(codes.numel() + 1, dtype=torch.uint8,
                       device=codes.device)
    return flat[1:].view(codes.shape).copy_(codes)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_GATHER_SHAPES)
def test_cuda_gather_kernels_match_plain_version(shape):
    """Both entries against the plain version, at an aligned base and at an
    unaligned one (byte loads); the bulk entry raises where it does not
    take the codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    codes, u, qs = _as_torch(*_gather_inputs(shape, seed=7), "cuda")
    want = gather_diagdot_ref(codes, u, qs)
    tol = 1e-4 * float(want.abs().max()) + 1e-3
    for base in (codes, _unaligned(codes)):
        for variant in VARIANTS:
            if variant == "bulk" and not bulk_fits(base):
                with pytest.raises(ValueError):
                    gather_diagdot(base, u, qs, variant=variant)
                continue
            launches = dict(gather_diagdot.route_launches)
            got = gather_diagdot(base, u, qs, variant=variant)
            torch.cuda.synchronize()
            assert gather_diagdot.route_launches[variant] == (
                launches[variant] + 1)
            err = float((got - want).abs().max())
            assert err <= tol, (shape, variant, base is codes, err)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("shape", [(300, 16, 128, 32, 8), (900, 7, 40, 333, 3),
                                   (100_000, 32, 128, 4096, 8),
                                   (5000, 1, 100, 333, 77)])
def test_cuda_gather_estimate_matches_epilogue_bits(shape, metric):
    """The fused entry's est equals the PyTorch epilogue applied to the same
    entry's dot bit for bit, and its ids exactly; u outside [0, C) is
    clamped as the plain version clamps it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    codes, u, qs = _as_torch(*_gather_inputs(shape, seed=8), "cuda")
    u[1, 0], u[-1, -1] = -5, shape[0] + 3
    qconst, xsq, ids = (t.cuda() for t in _estimate_inputs(codes, u, 8))
    coef, clamp = (2.0, True) if metric == "l2" else (1.0, False)
    for variant in VARIANTS:
        if variant == "bulk" and not bulk_fits(codes):
            continue
        launches = gather_estimate.launches
        est, nid = gather_estimate(codes, u, qs, qconst, coef, xsq, ids,
                                   clamp, variant=variant)
        dot = gather_diagdot(codes, u, qs, variant=variant)
        torch.cuda.synchronize()
        assert gather_estimate.launches == launches + 1
        want, want_ids = estimate_epilogue(dot, u, qconst, coef, xsq, ids,
                                           clamp)
        assert torch.equal(nid, want_ids), (shape, variant)
        assert torch.equal(est.view(torch.int32), want.view(torch.int32)), (
            shape, variant)
        plain, _ = gather_estimate_ref(codes, u, qs, qconst, coef, xsq, ids,
                                       clamp)
        fin = torch.isfinite(plain)
        assert torch.equal(fin, torch.isfinite(est))
        tol = 2e-4 * float(plain[fin].abs().max()) + 1e-2
        assert float((est[fin] - plain[fin]).abs().max()) <= tol


@pytest.mark.gpu
def test_cuda_probe_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for shape in PROBE_SHAPES + [(1000, 200, 77), (333, 300, 1),
                                 (4096, 256, 160)]:
        nids, seen = (torch.from_numpy(x).cuda()
                      for x in _probe_inputs(shape, seed=7))
        launches = ring_probe.launches
        got = ring_probe(nids, seen)
        torch.cuda.synchronize()
        assert ring_probe.launches == launches + 1
        assert torch.equal(got, ring_probe_ref(nids, seen)), shape


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["hash", "scan"])
def test_cuda_probe_routes_match_plain_version(route):
    """Both kernels against the plain version at the paths' shapes (full B),
    ragged and unaligned shapes, and the ids that break a hash table; the
    wrapper routes every path shape to "hash"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cases = []
    for B in (4096, 333):
        for K, S, S2 in PATH_PROBES:
            cases.append(_path_probe_inputs(B, K, S, S2, seed=B + K + S2))
    cases += [_path_probe_inputs(1000, 77, 13, 5, seed=1),
              _path_probe_inputs(1, 1, 1, 0, seed=2),
              _path_probe_inputs(333, 300, 0, 37, seed=3)]
    cases += [_edge_probe_inputs(c) for c in ("int_extremes", "one_id_row",
                                              "s1", "past_hash_limit")]
    for nids, ring, pool in cases:
        S2 = 0 if pool is None else pool.shape[1]
        if route == "hash" and ring.shape[1] + S2 > HASH_SEEN:
            continue
        tn, tr = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                  for a in (nids, ring))
        tp = (None if not S2 else
              torch.from_numpy(np.ascontiguousarray(pool)).cuda())
        want = ring_probe_ref(tn, tr, tp)
        # the same ids one int past a 16-byte boundary: no vector loads
        flat = torch.empty(tn.numel() + 1, dtype=torch.int32, device="cuda")
        shifted = flat[1:].view(tn.shape).copy_(tn)
        for ids in (tn, shifted):
            before = dict(ring_probe.route_launches)
            got = ring_probe_on(route, ids, tr, tp, counted=False)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (route, tn.shape, tr.shape, S2)
            assert ring_probe.route_launches == before
        before = ring_probe.route_launches[route]
        assert torch.equal(ring_probe_on(route, tn, tr, tp), want)
        assert ring_probe.route_launches[route] == before + 1
        if route == ring_probe_route(tr.shape[1], S2):
            before = ring_probe.route_launches[route]
            assert torch.equal(ring_probe(tn, tr, tp), want)
            assert ring_probe.route_launches[route] == before + 1
