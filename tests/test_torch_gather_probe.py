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

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.ops.gather_diagdot import (VARIANTS, bulk_fits,
                                                    estimate_epilogue,
                                                    gather_diagdot,
                                                    gather_diagdot_ref,
                                                    gather_estimate,
                                                    gather_estimate_ref)
from alayalite_tpu_torch.ops.ring_probe import ring_probe, ring_probe_ref

# (C, R, Dp, B, M); R = 1 is the sq8 traversal's view of its codes
GATHER_SHAPES = [(300, 16, 128, 32, 8), (50, 24, 96, 9, 5), (20, 7, 40, 13, 3),
                 (300, 1, 128, 32, 256), (50, 1, 96, 9, 20)]
# (B, K, S)
PROBE_SHAPES = [(64, 128, 96), (7, 33, 10), (5, 1, 3)]


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
