"""seed_scan: the plain version against the chain ``scan_seeds`` ran before
(an f32 product of the bf16-rounded operands, ``sq − 2·dot``, ``torch.topk``)
and against the JAX package's ``scan_seeds``, the tie rule, the wrapper's
checks, and (with a CUDA device) the hand-written kernels against the plain
version.

On the card the two versions sum the same bf16 × bf16 products (each exact
in f32) in another order, so where two scores lie within the sums' rounding
they may pick different points. The card's cases therefore re-score each
version's picks in float64 from the bf16-rounded values and hold the sorted
scores within ``4·D·2⁻²⁴·(max|sq| + 2·max Σ_d|q_d·v_d|)`` of each other, a
bound on the error of two f32 sums of D terms (and the final subtraction)
taken in different orders. On small-integer inputs every sum is exact, so
there the kernel must equal the plain version id for id, ties included.

JAX is imported inside the one test that uses it, so the card's cases run
where JAX is absent: ``python -m pytest --noconftest -m gpu
tests/test_torch_seed_scan.py``."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.index.search import scan_seeds, seed_sample_arrays
from alayalite_tpu_torch.ops.seed_scan import (MAX_NSEED, seed_scan,
                                               seed_scan_ref)


def _inputs(rng, B, S, D, metric="l2", spread=1.0, dev="cpu"):
    """Queries near sample points, the sample as the engine draws it
    (sorted int32 ids of a larger table, bf16 rows, norms or zeros)."""
    table = rng.normal(size=(4 * S, D)).astype(np.float32) * spread
    ids = np.sort(rng.choice(4 * S, size=S, replace=False)).astype(np.int32)
    pick = rng.integers(0, 4 * S, size=B)
    q = table[pick] + 0.3 * rng.normal(size=(B, D)).astype(np.float32)
    sample = seed_sample_arrays(torch.from_numpy(table),
                                torch.from_numpy(ids), metric)
    return (torch.from_numpy(q).to(dev),
            *(t.contiguous().to(dev) for t in sample))


def _integer_inputs(rng, B, S, D, dev="cpu"):
    """Small integers: every product and sum is exact in bf16 / f32, and
    each distinct sample row appears four times (exact ties)."""
    base = rng.integers(-4, 5, size=(S // 4, D)).astype(np.float32)
    vecs = np.repeat(base, 4, axis=0)
    q = rng.integers(-4, 5, size=(B, D)).astype(np.float32)
    ids = (np.arange(S, dtype=np.int32) * 3 + 1)
    sample = seed_sample_arrays(torch.from_numpy(vecs),
                                torch.arange(S, dtype=torch.int32), "l2")
    return (torch.from_numpy(q).to(dev), torch.from_numpy(ids).to(dev),
            sample[1].to(dev), sample[2].to(dev))


def _old_chain(q, ids, vecs, sq, nseed):
    """``scan_seeds`` as it computed before the kernel."""
    dot = q.to(torch.bfloat16).float() @ vecs.float().T
    d = sq[None, :] - 2.0 * dot
    _, sel = torch.topk(d, min(nseed, d.shape[1]), dim=1, largest=False)
    return ids[sel]


@pytest.mark.parametrize("B,S,D,nseed,metric", [
    (64, 512, 32, 8, "l2"), (17, 300, 40, 8, "l2"), (9, 256, 100, 16, "l2"),
    (33, 128, 16, 1, "l2"), (40, 384, 24, 8, "ip")])
def test_plain_version_equals_the_old_chain(B, S, D, nseed, metric):
    rng = np.random.default_rng(B * 7 + S)
    q, ids, vecs, sq = _inputs(rng, B, S, D, metric)
    got = seed_scan_ref(q, ids, vecs, sq, nseed)
    assert got.dtype == torch.int32 and got.shape == (B, nseed)
    torch.testing.assert_close(got, _old_chain(q, ids, vecs, sq, nseed),
                               rtol=0, atol=0)
    torch.testing.assert_close(scan_seeds(q, ids, vecs, sq, nseed), got,
                               rtol=0, atol=0)


def test_ties_take_the_lower_index_first():
    rng = np.random.default_rng(3)
    q, ids, vecs, sq = _integer_inputs(rng, 32, 128, 16)
    got = seed_scan_ref(q, ids, vecs, sq, 8).numpy()
    d = (sq[None, :] - 2.0 * (q @ vecs.float().T)).numpy()
    want = ids.numpy()[np.argsort(d, axis=1, kind="stable")[:, :8]]
    np.testing.assert_array_equal(got, want)
    # four copies of each row: the nearest row's copies come first, in order
    best = np.argsort(d, axis=1, kind="stable")[:, 0]
    np.testing.assert_array_equal(got[:, :4] - got[:, :1],
                                  np.tile([0, 3, 6, 9], (32, 1)))
    assert (best % 4 == 0).all()


def test_plain_version_matches_jax_top_k():
    """Where the JAX package takes the exact ``lax.top_k`` (S ≤ 4·nseed),
    the two select the same ids in the same order, ties included."""
    import jax.numpy as jnp

    from alayalite_tpu.index.search import scan_seeds as jax_scan_seeds

    rng = np.random.default_rng(5)
    q, ids, vecs, sq = _integer_inputs(rng, 24, 32, 16)
    want = np.asarray(jax_scan_seeds(
        jnp.asarray(q.numpy()), jnp.asarray(ids.numpy()),
        jnp.asarray(vecs.float().numpy(), dtype=jnp.bfloat16),
        jnp.asarray(sq.numpy()), nseed=8))
    np.testing.assert_array_equal(seed_scan_ref(q, ids, vecs, sq, 8).numpy(),
                                  want)


@pytest.mark.parametrize("S", [1, 5, 8])
def test_small_samples_clamp_nseed(S):
    rng = np.random.default_rng(S)
    q, ids, vecs, sq = _inputs(rng, 6, S, 8)
    got = scan_seeds(q, ids, vecs, sq, nseed=min(8, S))
    assert got.shape == (6, S)
    for row in got.tolist():                 # every sample point, once
        assert sorted(row) == ids.tolist()
    torch.testing.assert_close(scan_seeds(q, ids, vecs, sq, nseed=8), got,
                               rtol=0, atol=0)


def test_nan_scores_come_last():
    rng = np.random.default_rng(11)
    q, ids, vecs, sq = _inputs(rng, 4, 16, 8)
    sq = sq.clone()
    sq[3] = float("nan")
    got = seed_scan_ref(q, ids, vecs, sq, 16)
    assert (got[:, -1] == ids[3]).all()


def test_wrapper_counts_calls_and_launches_nothing_on_the_cpu():
    rng = np.random.default_rng(2)
    q, ids, vecs, sq = _inputs(rng, 5, 128, 16)
    calls, launches = seed_scan.calls, seed_scan.launches
    scan_seeds(q, ids, vecs, sq)
    assert seed_scan.calls == calls + 1
    assert seed_scan.launches == launches


@pytest.mark.parametrize("what", ["q_dtype", "vecs_dtype", "sq_dtype",
                                  "ids_dtype", "width", "sq_shape",
                                  "nseed_0", "nseed_17", "strided",
                                  "device"])
def test_wrapper_raises_on_bad_inputs(what):
    rng = np.random.default_rng(4)
    q, ids, vecs, sq = _inputs(rng, 5, 128, 16)
    nseed = 8
    err = TypeError
    if what == "q_dtype":
        q = q.double()
    elif what == "vecs_dtype":
        vecs = vecs.float()
    elif what == "sq_dtype":
        sq = sq.double()
    elif what == "ids_dtype":
        ids = ids.long()
    elif what == "width":
        q = q[:, :8].contiguous()
    elif what == "sq_shape":
        sq = sq[:64]
    elif what == "nseed_0":
        nseed, err = 0, ValueError
    elif what == "nseed_17":
        nseed, err = MAX_NSEED + 1, ValueError
    elif what == "strided":
        q, err = torch.cat([q, q], 1)[:, ::2], ValueError
    elif what == "device":
        q, err = q.to("meta"), ValueError
    with pytest.raises(err):
        seed_scan(q, ids, vecs, sq, nseed)


# ---------------------------------------------------------------- the card

# (B, S, D, nseed, metric): the bsq8 slice, a served batch, ragged B and S,
# D off the 64-wide ring slices (100, the element route) and past the
# 128-row blocks' shared memory (960), nseed 1 / 16, inner product, a sample
# shorter than nseed, and S off the 64-row tiles with one split
GPU_CASES = [(4096, 16384, 128, 8, "l2"), (52, 16384, 128, 8, "l2"),
             (333, 1000, 128, 8, "l2"), (4097, 16448, 128, 8, "l2"),
             (1, 130, 128, 8, "l2"), (97, 1000, 100, 8, "l2"),
             (130, 2048, 960, 8, "l2"), (513, 4096, 128, 1, "l2"),
             (515, 4096, 128, 16, "l2"), (700, 4096, 128, 8, "ip"),
             (64, 5, 128, 5, "l2"), (200, 70, 64, 8, "l2")]


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rescored(q, vecs, sq, pos):
    """float64 scores of sample positions ``pos`` [B, k] from the rounded
    values."""
    q64 = q.to(torch.bfloat16).double()
    v64 = vecs.double()[pos.long()]                       # [B, k, D]
    return sq.double()[pos.long()] - 2.0 * torch.einsum("bd,bkd->bk", q64, v64)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D,nseed,metric", GPU_CASES)
def test_kernel_matches_plain_version(B, S, D, nseed, metric):
    dev = _gpu()
    rng = np.random.default_rng(B + S + D + nseed)
    q, ids, vecs, sq = _inputs(rng, B, S, D, metric, dev=dev)
    launches = seed_scan.launches
    got = seed_scan(q, ids, vecs, sq, nseed)
    torch.cuda.synchronize()
    assert seed_scan.launches == launches + 1
    want = seed_scan_ref(q, ids, vecs, sq, nseed)
    k = min(nseed, S)
    assert got.shape == want.shape == (B, k)
    # ids back to sample positions (the ids are sorted)
    pos_got = torch.searchsorted(ids, got)
    pos_want = torch.searchsorted(ids, want)
    assert (ids[pos_got.clamp(max=S - 1)] == got).all()
    assert (torch.sort(pos_got, 1).values.diff(dim=1) > 0).all()   # distinct
    s_got = _rescored(q, vecs, sq, pos_got)
    s_want = _rescored(q, vecs, sq, pos_want)
    terms = (q.to(torch.bfloat16).double().abs()
             @ vecs.double().abs().T).max(1).values
    tol = 4 * D * 2.0 ** -24 * (sq.double().abs().max() + 2 * terms)
    err = (torch.sort(s_got, 1).values - s_want).abs().max(1).values
    assert (err <= tol).all(), (float(err.max()), float(tol.min()))
    # the kernel's order is ascending by its own scores, so by the rescored
    # ones within the same bound
    assert (s_got.diff(dim=1) >= -tol[:, None]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D", [(4096, 16384, 128), (52, 4096, 96),
                                   (300, 1000, 100)])
def test_kernel_exact_on_integers_with_ties(B, S, D):
    dev = _gpu()
    rng = np.random.default_rng(S + D)
    q, ids, vecs, sq = _integer_inputs(rng, B, S, D, dev=dev)
    for nseed in (1, 8, 16):
        got = seed_scan(q, ids, vecs, sq, nseed)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), seed_scan_ref(
            q.cpu(), ids.cpu(), vecs.cpu(), sq.cpu(), nseed), rtol=0, atol=0)


@pytest.mark.gpu
def test_captured_replay_equals_uncaptured_call():
    dev = _gpu()
    rng = np.random.default_rng(21)
    q, ids, vecs, sq = _inputs(rng, 4096, 16384, 128, dev=dev)
    want = seed_scan(q, ids, vecs, sq, 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        seed_scan(q, ids, vecs, sq, 8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = seed_scan(q, ids, vecs, sq, 8)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.gpu
def test_splits_follow_d_back_and_forth():
    """The blocks an SM, and so the splits, are asked again when D changes
    the shared memory a block takes; a wider D in between leaves the
    narrow one's splits as they were."""
    import ctypes

    from alayalite_tpu_torch.ops._build import launch
    from alayalite_tpu_torch.ops.seed_scan import _entries

    dev = _gpu()
    plan, _ = _entries()

    def splits(D):
        n = ctypes.c_int(0)
        launch(plan, dev, 4096, 16384, D, 8, ctypes.byref(n))
        return n.value

    narrow = splits(128)
    assert splits(512) <= narrow
    assert splits(128) == narrow
