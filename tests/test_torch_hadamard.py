"""The port's FWHT and RaBitQ rotations against the JAX package's: the
cases of ``tests/test_hadamard.py`` on ``ops/hadamard.fwht_np`` (JAX's
device ``fwht`` / ``fht_kac_rotate`` as the reference), and
``make_fht_kac_rotation`` / ``make_rotation`` equal to JAX's bit for
bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from alayalite_tpu.ops import hadamard as jax_h
from alayalite_tpu.spaces import rabitq as jax_rq
from alayalite_tpu_torch.ops.hadamard import fwht_np
from alayalite_tpu_torch.spaces.rabitq import (make_fht_kac_rotation,
                                               make_rotation)


def _np_hadamard(d):
    h = np.array([[1.0]])
    while h.shape[0] < d:
        h = np.block([[h, h], [h, -h]])
    return h


@pytest.mark.parametrize("d", [2, 8, 64, 256])
def test_fwht_matches_matrix(rng, d):
    x = rng.normal(size=(5, d)).astype(np.float32)
    got = fwht_np(x, normalize=False)
    np.testing.assert_allclose(got, x @ _np_hadamard(d).T, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jax_h.fwht(jnp.asarray(x), normalize=False)),
        rtol=1e-6, atol=1e-5)


def test_fwht_orthonormal_involution(rng):
    x = rng.normal(size=(3, 128)).astype(np.float32)
    y = fwht_np(fwht_np(x))
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5)


def test_fwht_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        fwht_np(np.zeros((2, 100)))
    with pytest.raises(ValueError):
        fwht_np(np.zeros((2, 6), dtype=np.float32))


def test_fht_kac_preserves_norm_and_matches_jax(rng):
    """Rounds of (sign flip, fwht_np) against JAX's device
    fht_kac_rotate."""
    x = rng.normal(size=(4, 64)).astype(np.float32)
    signs = rng.choice([-1.0, 1.0], size=(4, 64)).astype(np.float32)
    y = x
    for r in range(4):
        y = fwht_np(y * signs[r])
    np.testing.assert_allclose(np.linalg.norm(y, axis=1),
                               np.linalg.norm(x, axis=1), rtol=1e-4)
    want = np.asarray(jax_h.fht_kac_rotate(jnp.asarray(x),
                                           jnp.asarray(signs)))
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


def test_fwht_np_bit_for_bit(rng):
    x = rng.normal(size=(16, 128))
    np.testing.assert_array_equal(fwht_np(x), jax_h.fwht_np(x))
    np.testing.assert_array_equal(fwht_np(x, normalize=False),
                                  jax_h.fwht_np(x, normalize=False))


def test_fht_kac_materialized_matrix_matches_op():
    """The materialized matrix applied as x @ rot.T equals JAX's device
    fht_kac_rotate (the sign flips and FWHTs run in turn), and is
    orthonormal."""
    dim, rounds, seed = 64, 4, 7
    rot = make_fht_kac_rotation(dim, seed=seed, rounds=rounds)
    rng = np.random.default_rng(seed)
    signs = np.stack([rng.choice([-1.0, 1.0], size=dim)
                      for _ in range(rounds)]).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(8, dim)).astype(np.float32)
    want = np.asarray(jax_h.fht_kac_rotate(jnp.asarray(x),
                                           jnp.asarray(signs), rounds=rounds))
    np.testing.assert_allclose(x @ rot.T, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rot @ rot.T, np.eye(dim), atol=1e-4)


def test_fht_kac_non_pow2_pads_like_reference():
    rot = make_fht_kac_rotation(96, seed=3)
    assert rot.shape == (128, 96)
    full = make_fht_kac_rotation(128, seed=3)
    np.testing.assert_allclose(rot, full[:, :96], atol=0)
    x = np.random.default_rng(0).normal(size=(6, 96)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, 32)))
    np.testing.assert_allclose(x @ rot.T, xp @ full.T, atol=1e-5)


@pytest.mark.parametrize("dim,seed", [(32, 0), (64, 7), (96, 3), (128, 0)])
def test_rotations_equal_jax_bit_for_bit(dim, seed):
    np.testing.assert_array_equal(make_fht_kac_rotation(dim, seed),
                                  jax_rq.make_fht_kac_rotation(dim, seed))
    np.testing.assert_array_equal(make_rotation(dim, seed),
                                  jax_rq.make_rotation(dim, seed))
