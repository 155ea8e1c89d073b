"""gather_diagdot and ring_probe: the port's plain versions against the JAX
functions and the TPU kernels' formulas, the CPU wrappers' routing and
checks, the hop that calls them, and (with a CUDA device) the hand-written
kernels.

Tolerance of gather_diagdot, rtol 1e-5 / atol 1e-3: (c − 128) is exact in
bf16 and every bf16 × bf16 product is exact in f32, so the sides differ
only in the order of the f32 sums. ring_probe is exact.

JAX is imported inside the tests that use it, so the card's cases run where
JAX is absent: ``python -m pytest --noconftest -m gpu
tests/test_torch_gather_probe.py``."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.ops.gather_diagdot import (gather_diagdot,
                                                    gather_diagdot_ref)
from alayalite_tpu_torch.ops.ring_probe import ring_probe, ring_probe_ref

# (C, R, Dp, B, M)
GATHER_SHAPES = [(300, 16, 128, 32, 8), (50, 24, 96, 9, 5), (20, 7, 40, 13, 3)]
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


def test_cpu_wrappers_run_plain_versions_and_count_calls():
    codes, u, qs = _as_torch(*_gather_inputs(GATHER_SHAPES[1], seed=1))
    for variant in ("direct", "staged"):
        calls, launches = gather_diagdot.calls, gather_diagdot.launches
        got = gather_diagdot(codes, u, qs, variant=variant)
        assert gather_diagdot.calls == calls + 1
        assert gather_diagdot.launches == launches   # no kernel on the CPU
        assert torch.equal(got, gather_diagdot_ref(codes, u, qs))
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


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_estimate_many_matches_jax_and_estimate_for(metric):
    """``BQGSpace.estimate_many`` (gather_diagdot) against the JAX space on
    the same rows and adjacency, and against the port's own one-node
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
    jsp = JaxBQG.create(n, dim, metric=metric, degree=r).fit(jnp.asarray(data))
    jsp = jsp.update_neighbors(nbrs)
    jest, jids = jsp.estimate_many(jsp.query_ctx(jnp.asarray(q)),
                                   jnp.asarray(u))
    sp = BQGSpace.create(n, dim, metric=metric, degree=r).fit(
        torch.from_numpy(data))
    sp.update_neighbors(torch.from_numpy(nbrs))
    ctx = sp.query_ctx(torch.from_numpy(q))
    calls = gather_diagdot.calls
    est, ids = sp.estimate_many(ctx, torch.from_numpy(u))
    assert gather_diagdot.calls == calls + 1
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-4,
                               atol=1e-2)
    for m in range(M):
        e1, i1 = sp.estimate_for(ctx, torch.from_numpy(u[:, m]))
        assert torch.equal(i1, ids[:, m * r:(m + 1) * r])
        np.testing.assert_allclose(e1.numpy(),
                                   est[:, m * r:(m + 1) * r].numpy(),
                                   rtol=1e-6, atol=1e-4)


def test_hop_goes_through_both_wrappers():
    """One block search calls gather_diagdot and ring_probe once per hop;
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
    g, p = gather_diagdot.calls, ring_probe.calls
    d, i = block_beam_search(sp, seeds, q, k=5, ef=16, n_expand=2)
    hops = gather_diagdot.calls - g
    assert hops > 0 and ring_probe.calls - p == hops
    assert (i[:, 0] == torch.arange(6)).all() and torch.isfinite(d).all()
    raw = RawSpace.create(n, dim).fit(data)
    p = ring_probe.calls
    d2, i2 = beam_search(raw, nbrs, seeds, q, k=5, ef=16, n_expand=2)
    assert ring_probe.calls - p >= 2
    assert (i2[:, 0] == torch.arange(6)).all()


@pytest.mark.gpu
def test_cuda_gather_kernels_match_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    shapes = GATHER_SHAPES + [(5000, 24, 96, 1000, 5), (900, 7, 40, 333, 3),
                              (100_000, 32, 128, 4096, 8)]
    for shape in shapes:
        codes, u, qs = _as_torch(*_gather_inputs(shape, seed=7), "cuda")
        want = gather_diagdot_ref(codes, u, qs)
        tol = 1e-4 * float(want.abs().max()) + 1e-3
        for variant in ("direct", "staged"):
            launches = gather_diagdot.launches
            got = gather_diagdot(codes, u, qs, variant=variant)
            torch.cuda.synchronize()
            assert gather_diagdot.launches == launches + 1
            assert float((got - want).abs().max()) <= tol, (shape, variant)
        # a base that is not 16-byte aligned takes the byte-load paths
        flat = torch.empty(codes.numel() + 1, dtype=torch.uint8,
                           device="cuda")
        off = flat[1:].view(codes.shape).copy_(codes)
        for variant in ("direct", "staged"):
            got = gather_diagdot(off, u, qs, variant=variant)
            assert float((got - want).abs().max()) <= tol, (shape, variant)


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
