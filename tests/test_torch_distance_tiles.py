"""l2_tile and sq8_tile: the port's plain versions against the JAX
functions they replace (Pallas in interpret mode, and XLA's ``pairwise``),
the CPU wrappers' routing and checks, and (with a CUDA device) the
hand-written kernels against their plain versions.

Tolerance rtol 1e-5 / atol 1e-3 between the packages: the arithmetic is the
same step for step (for sq8 the bf16 roundings are the same and every
bf16 × bf16 product is exact in f32), so only the order of the f32 sums
differs, amplified by the cancellation in |q|² + |x|² − 2 q·x.

JAX is imported inside the tests that use it, so the card's cases run
where JAX is absent: ``python -m pytest --noconftest -m gpu
tests/test_torch_distance_tiles.py``."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.ops.l2_tile import l2_tile, l2_tile_ref
from alayalite_tpu_torch.ops.sq8_tile import sq8_tile, sq8_tile_ref

RTOL, ATOL = 1e-5, 1e-3
GPU_SHAPES = [(256, 512, 128), (1000, 3000, 96), (333, 777, 40), (5, 17, 40),
              (1, 16384, 128)]
# sq8_tile's blocks take 128 queries x 128 codes, 64 a warpgroup, with D in
# 64-wide slices: Q and N off those multiples, D padded (40, 100), D past the
# 256 whose query rows stay whole in shared memory (960), and an output
# past 2^31 bytes
SQ8_GPU_SHAPES = GPU_SHAPES + [(4096, 65536, 128), (97, 1000, 100),
                               (130, 333, 960), (65, 129, 96),
                               (8192, 65600, 128)]


def _rows(rng, n, dim, spread=1.0):
    return (rng.normal(size=(n, dim)) * spread).astype(np.float32)


def _t(a):
    """A tensor holding a copy of a (JAX) array."""
    return torch.from_numpy(np.array(a))


def _sq8_inputs(shape, seed):
    """Codes, dmin and scale from a fit of the JAX package's SQSpace."""
    import jax.numpy as jnp

    from alayalite_tpu.spaces.sq import SQSpace

    Q, N, D = shape
    rng = np.random.default_rng(seed)
    v = _rows(rng, N, D, 2.0)
    q = _rows(rng, Q, D)
    sp = SQSpace.create(N, D, bits=8).fit(jnp.asarray(v))
    return q, sp


def test_l2_ref_matches_pallas_interpret():
    import jax.numpy as jnp

    from alayalite_tpu.ops.pallas_distance import pairwise_l2_pallas

    rng = np.random.default_rng(0)
    q, x = _rows(rng, 256, 128), _rows(rng, 512, 128)
    want = np.asarray(pairwise_l2_pallas(jnp.asarray(q), jnp.asarray(x),
                                         tq=128, tn=256, interpret=True))
    got = l2_tile_ref(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(37, 300, 96), (5, 17, 40)])
def test_l2_ref_matches_jax_pairwise_ragged(shape):
    import jax.numpy as jnp

    from alayalite_tpu.ops.distance import pairwise

    Q, N, D = shape
    rng = np.random.default_rng(sum(shape))
    q, x = _rows(rng, Q, D, 3.0), _rows(rng, N, D, 3.0)
    want = np.asarray(pairwise(jnp.asarray(q), jnp.asarray(x)))
    got = l2_tile_ref(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sq8_ref_matches_pallas_interpret():
    import jax.numpy as jnp

    from alayalite_tpu.ops.pallas_distance import sq8_pairwise_pallas

    q, sp = _sq8_inputs((256, 512, 128), seed=1)
    want = np.asarray(sq8_pairwise_pallas(
        jnp.asarray(q), sp.codes, sp.dmin, sp.scale, sp.xhat_sq, tq=128,
        tn=256, interpret=True))
    got = sq8_tile_ref(_t(q), _t(sp.codes), _t(sp.dmin),
                       _t(sp.scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sq8_ref_matches_pallas_interpret_at_d100():
    """D = 100: not a multiple of 16, which the card's kernel pads with
    zeros."""
    import jax.numpy as jnp

    from alayalite_tpu.ops.pallas_distance import sq8_pairwise_pallas

    q, sp = _sq8_inputs((128, 256, 100), seed=4)
    want = np.asarray(sq8_pairwise_pallas(
        jnp.asarray(q), sp.codes, sp.dmin, sp.scale, sp.xhat_sq, tq=128,
        tn=256, interpret=True))
    got = sq8_tile_ref(_t(q), _t(sp.codes), _t(sp.dmin),
                       _t(sp.scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(256, 512, 128), (37, 300, 96)])
def test_sq8_ref_matches_decoded_rows(shape):
    """The tile approximates the exact distance to the decoded rows within
    tests/test_pallas.py's bf16 tolerance."""
    import jax.numpy as jnp

    q, sp = _sq8_inputs(shape, seed=2)
    dec = np.asarray(sp.decode(jnp.arange(shape[1])))
    want = ((q[:, None, :] - dec[None, :, :]) ** 2).sum(-1)
    got = sq8_tile_ref(_t(q), _t(sp.codes), _t(sp.dmin),
                       _t(sp.scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=2.0)


def test_cpu_wrappers_run_plain_versions_and_count_calls():
    rng = np.random.default_rng(3)
    q, x = torch.from_numpy(_rows(rng, 9, 20)), torch.from_numpy(_rows(rng, 31, 20))
    codes = torch.from_numpy(rng.integers(0, 256, size=(31, 20),
                                          dtype=np.uint8))
    dmin = torch.from_numpy(_rows(rng, 1, 20)[0])
    scale = torch.full((20,), 0.02)
    before = (l2_tile.calls, l2_tile.launches, sq8_tile.calls,
              sq8_tile.launches)
    assert torch.equal(l2_tile(q, x), l2_tile_ref(q, x))
    assert torch.equal(sq8_tile(q, codes, dmin, scale),
                       sq8_tile_ref(q, codes, dmin, scale))
    # calls count on any device; no kernel launches on the CPU
    assert (l2_tile.calls, l2_tile.launches, sq8_tile.calls,
            sq8_tile.launches) == (before[0] + 1, before[1], before[2] + 1,
                                   before[3])


def test_wrappers_reject_bad_inputs():
    q = torch.zeros((4, 16))
    x = torch.zeros((8, 16))
    c = torch.zeros((8, 16), dtype=torch.uint8)
    m, s = torch.zeros(16), torch.ones(16)
    with pytest.raises(TypeError):
        l2_tile(q.double(), x)
    with pytest.raises(TypeError):
        l2_tile(q, x[:, :8])
    with pytest.raises(ValueError):
        l2_tile(q[:, ::2], x[:, ::2])
    with pytest.raises(TypeError):
        sq8_tile(q, c.to(torch.int16), m, s)
    with pytest.raises(TypeError):
        sq8_tile(q, c, m[:8], s)
    with pytest.raises(ValueError):
        sq8_tile(q[:, ::2], c[:, ::2], m[::2], s[::2])


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_close(got, want, what):
    torch.cuda.synchronize()
    tol = 1e-4 * float(want.abs().max()) + 1e-3
    err = float((got - want).abs().max())
    assert err <= tol, (what, err, tol)


@pytest.mark.gpu
def test_l2_kernel_matches_plain_version():
    dev = _gpu()
    rng = np.random.default_rng(7)
    for Q, N, D in GPU_SHAPES:
        q = torch.from_numpy(_rows(rng, Q, D, 3.0)).to(dev)
        x = torch.from_numpy(_rows(rng, N, D, 3.0)).to(dev)
        launches = l2_tile.launches
        got = l2_tile(q, x)
        assert l2_tile.launches == launches + 1
        _assert_close(got, l2_tile_ref(q, x), (Q, N, D))


def _sq8_gpu_inputs(rng, Q, N, D, dev):
    q = torch.from_numpy(_rows(rng, Q, D)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 256, size=(N, D),
                                          dtype=np.uint8)).to(dev)
    dmin = torch.from_numpy(_rows(rng, 1, D)[0] - 4.0).to(dev)
    scale = torch.from_numpy(rng.uniform(0.01, 0.05, size=D)
                             .astype(np.float32)).to(dev)
    return q, codes, dmin, scale


@pytest.mark.gpu
def test_sq8_kernel_wide_d_on_both_load_routes():
    """D past 6144: scale and shift (8·D bytes) pass the 48 KB of dynamic
    shared memory a kernel may take without asking. The 16-byte-load route
    (D % 16 == 0) and the element route are other kernel instances, and
    each must ask for itself: the wider aligned call first, then a narrower
    unaligned one, then the aligned one again."""
    dev = _gpu()
    rng = np.random.default_rng(9)
    for Q, N, D in ((70, 300, 6400), (70, 300, 6200), (130, 200, 6400)):
        q, codes, dmin, scale = _sq8_gpu_inputs(rng, Q, N, D, dev)
        _assert_close(sq8_tile(q, codes, dmin, scale),
                      sq8_tile_ref(q, codes, dmin, scale), (Q, N, D))


@pytest.mark.gpu
def test_sq8_kernel_matches_plain_version():
    dev = _gpu()
    rng = np.random.default_rng(8)
    for Q, N, D in SQ8_GPU_SHAPES:
        q, codes, dmin, scale = _sq8_gpu_inputs(rng, Q, N, D, dev)
        launches = sq8_tile.launches
        got = sq8_tile(q, codes, dmin, scale)
        assert sq8_tile.launches == launches + 1
        if Q * N * 4 < 2 ** 31:
            _assert_close(got, sq8_tile_ref(q, codes, dmin, scale),
                          (Q, N, D))
            continue
        # the plain version of the whole output would need three more
        # copies of it: hold the last query rows, whose offsets pass 2^31
        tail = slice(Q - 64, Q)
        _assert_close(got[tail], sq8_tile_ref(q[tail], codes, dmin, scale),
                      (Q, N, D, "rows past 2^31 bytes"))
        del got
        torch.cuda.empty_cache()
