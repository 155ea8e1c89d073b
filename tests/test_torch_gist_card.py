"""The kernels of bsq8 hnsw at GIST1M's width (D 960, code rows of 1,024
bytes) on the card, at the shapes of the benchmark cell
``gist-bsq8-batch``: one 1,024-row query slice, 8 pops of 32-neighbour
blocks a hop, a pool of 96.

    python -m pytest --noconftest -m gpu tests/test_torch_gist_card.py

Without a CUDA device every case skips (the kernels have no CPU mode).

- ``gather_estimate`` at (B 1,024, M 8, R 32, Dp 1,024) over 100,000
  nodes' blocks (3.3 GB): its estimate equals the PyTorch epilogue on the
  same entry's dot bit for bit, its ids exactly, and the plain version
  within 2e-4 of the largest estimate (bf16 products summed in another
  order).
- A captured 1,024-row slice at D 960 replays the bits of the same search
  run uncaptured, twice.
- ``gather_dot`` over 1M × 960 f32 rows at the slice's seed (K 8) and
  final re-score (K 96) shapes: within 1e-5 of |q|² + |x|² of the float64
  distance (f32 sums of 960 products; rounded apart, as the kernel
  promises PyTorch's order at D 128 only).
"""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch import Client
from alayalite_tpu_torch.index import captured
from alayalite_tpu_torch.ops.gather_diagdot import (estimate_epilogue,
                                                    gather_diagdot,
                                                    gather_estimate,
                                                    gather_estimate_ref)
from alayalite_tpu_torch.ops.gather_dot import gather_dot

B, M, R, D, DP = 1024, 8, 32, 960, 1024


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gather_estimate_at_the_cells_hop():
    dev = _gpu()
    g = torch.Generator(device=dev).manual_seed(27)
    C = 100_000
    codes = torch.randint(0, 256, (C, R, DP), generator=g, device=dev,
                          dtype=torch.uint8)
    codes[:, :, D:] = 128                     # the centre byte in the pad
    u = torch.randint(0, C, (B, M), generator=g, device=dev,
                      dtype=torch.int32)
    u[:, 1] = u[:, 0]                          # a node popped twice
    u[B // 4:B // 2] = 0                       # inactive pops on node 0
    qs = torch.randn((B, DP), generator=g, device=dev).to(torch.bfloat16)
    qconst = torch.randn((B,), generator=g, device=dev) * 1e3
    xsq = torch.rand((C, R), generator=g, device=dev) * 1e3
    ids = torch.randint(-1, C, (C, R), generator=g, device=dev,
                        dtype=torch.int32)
    launches, nbytes = gather_estimate.launches, gather_estimate.code_bytes
    est, nid = gather_estimate(codes, u, qs, qconst, 2.0, xsq, ids, True)
    dot = gather_diagdot(codes, u, qs)
    torch.cuda.synchronize()
    assert gather_estimate.launches == launches + 1
    assert gather_estimate.code_bytes == nbytes + B * M * R * DP
    want, want_ids = estimate_epilogue(dot, u, qconst, 2.0, xsq, ids, True)
    assert torch.equal(nid, want_ids)
    assert torch.equal(est.view(torch.int32), want.view(torch.int32))
    plain, _ = gather_estimate_ref(codes, u, qs, qconst, 2.0, xsq, ids, True)
    assert torch.equal(torch.isfinite(plain), torch.isfinite(est))
    fin = torch.isfinite(plain)
    tol = 2e-4 * float(plain[fin].abs().max()) + 1e-2
    assert float((est[fin] - plain[fin]).abs().max()) <= tol


@pytest.mark.gpu
def test_captured_slice_at_d960_replays_the_uncaptured_bits():
    dev = _gpu()
    rng = np.random.default_rng(27)
    centers = rng.normal(size=(50, D)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 50, 20_000)]
         + rng.normal(size=(20_000, D)).astype(np.float32))
    q = (centers[rng.integers(0, 50, 1000)]
         + rng.normal(size=(1000, D)).astype(np.float32))
    idx = Client(device="cuda").create_index(
        "g", quantization_type="bsq8", capacity=20_000, max_nbrs=32,
        prune_alpha=1.2, beam_expand=8)
    idx.fit(x)
    eng = idx._engine
    with captured.eager():
        want = eng._batch_search_impl(q, 10, 96)
    replays = captured.stats["replays"]
    for _ in range(2):                 # the capture, then a replay
        got = eng._batch_search_impl(q, 10, 96)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
    assert captured.stats["replays"] - replays == 2     # one 1,024-row slice


@pytest.mark.gpu
@pytest.mark.parametrize("K", [8, 96])
def test_gather_dot_at_the_cells_shapes(K):
    dev = _gpu()
    g = torch.Generator(device=dev).manual_seed(K)
    C = 1_000_000
    data = torch.randn((C, D), generator=g, device=dev)
    data += torch.randn((1, D), generator=g, device=dev) * 4.0
    q = data[:B] + torch.randn((B, D), generator=g, device=dev)
    ids = torch.randint(0, C, (B, K), generator=g, device=dev,
                        dtype=torch.int32)
    q_sq, x_sq = (q * q).sum(-1), (data * data).sum(-1)
    got = gather_dot(data, ids, q, q_sq, x_sq)
    rows = data[ids.long()].double()
    scale = (q.double() ** 2).sum(-1)[:, None] + (rows ** 2).sum(-1)
    want = torch.clamp(scale - 2.0 * (rows * q.double()[:, None, :]).sum(-1),
                       min=0.0)
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * scale).all()), float((err / scale).max())
