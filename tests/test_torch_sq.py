"""SQSpace (sq8) against the JAX package's on the same rows: codes
byte-identical (``torch.round`` and ``jnp.round`` both round half to even),
``dmin``/``scale``/``xhat_sq`` within 1e-6 relative (sums in another
order), insert past capacity, remove, and the npz arrays both ways."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.spaces.sq import SQSpace

N, DIM, CAP = 300, 24, 320


def _rows(seed, n=N, dim=DIM):
    return (np.random.default_rng(seed).normal(size=(n, dim)) * 3.0
            ).astype(np.float32)


def _both(metric, v, cap=CAP):
    import jax.numpy as jnp

    from alayalite_tpu.spaces.sq import SQSpace as JaxSQ

    j = JaxSQ.create(cap, DIM, bits=8, metric=metric).fit(jnp.asarray(v))
    p = SQSpace.create(cap, DIM, bits=8, metric=metric).fit(
        torch.from_numpy(v))
    return j, p


def _assert_same(j, p):
    np.testing.assert_array_equal(p.codes.numpy(), np.asarray(j.codes))
    for key in ("dmin", "scale", "xhat_sq"):
        np.testing.assert_allclose(getattr(p, key).numpy(),
                                   np.asarray(getattr(j, key)), rtol=1e-6,
                                   atol=1e-30)
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(j.valid))
    assert p.num == int(j.num)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_fit_matches_jax(metric):
    j, p = _both(metric, _rows(1))
    _assert_same(j, p)
    assert p.metric == j.metric and p.user_metric == j.user_metric
    # the decoded rows agree too
    ids = np.arange(0, N, 7)
    np.testing.assert_allclose(p.decode(torch.from_numpy(ids)).numpy(),
                               np.asarray(j.decode(ids)), rtol=1e-6,
                               atol=1e-6)


def test_insert_past_capacity_keeps_rows():
    import jax.numpy as jnp

    j, p = _both("l2", _rows(2))
    new = _rows(3, n=30)                    # 20 fit the capacity, 10 do not
    j, jids = j.insert(jnp.asarray(new))
    pids = p.insert(torch.from_numpy(new))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    assert (pids[:20].numpy() == np.arange(N, CAP)).all()
    assert (pids[20:] == -1).all()
    _assert_same(j, p)
    before = p.codes.clone()
    assert (p.insert(torch.from_numpy(new[:2])) == -1).all()
    assert torch.equal(p.codes, before) and p.num == CAP


def test_remove_matches_jax():
    j, p = _both("l2", _rows(4))
    ids = np.array([3, 5, -1, 17, 5, CAP + 3], dtype=np.int32)
    j = j.remove(ids)
    p.remove(torch.from_numpy(ids))
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(j.valid))
    assert not p.valid[[3, 5, 17]].any() and p.valid[0]
    # JAX scatters a −1 (clipped to slot 0) beside a real 0, and the write
    # that keeps slot 0 valid may win; the port drops −1 before scattering
    p.remove(torch.tensor([0, -1], dtype=torch.int32))
    assert not p.valid[0]


def test_save_arrays_match_and_load_a_jax_save(tmp_path):
    from alayalite_tpu.spaces.sq import SQSpace as JaxSQ

    j, p = _both("cos", _rows(5))
    ja, pa = j.save_arrays(), p.save_arrays()
    assert set(ja) == set(pa)
    for key in ("codes", "valid", "num", "metric", "bits", "dim"):
        np.testing.assert_array_equal(np.asarray(pa[key]),
                                      np.asarray(ja[key]))
    for key in ("dmin", "scale", "xhat_sq"):
        np.testing.assert_allclose(pa[key], ja[key], rtol=1e-6)
    np.savez(tmp_path / "j.npz", **ja)
    np.savez(tmp_path / "p.npz", **pa)
    with np.load(tmp_path / "j.npz") as z:
        _assert_same(j, SQSpace.load_arrays(dict(z.items())))
    with np.load(tmp_path / "p.npz") as z:
        back = JaxSQ.load_arrays(dict(z.items()))
    np.testing.assert_array_equal(np.asarray(back.codes), p.codes.numpy())


def test_unported_parts_raise():
    """Only 8 and 4 bits exist, as in the JAX package; both are ported, with
    ``gather_dists`` (tests/test_torch_graph_search.py holds them to JAX)."""
    for bits in (2, 1, 16):
        with pytest.raises(ValueError):
            SQSpace.create(10, 4, bits=bits)
    assert SQSpace.create(10, 5, bits=4).codes.shape == (10, 3)
    sp = SQSpace.create(10, 4).fit(torch.zeros((10, 4)))
    d = sp.gather_dists(torch.zeros((1, 4)), torch.zeros((1, 3),
                                                         dtype=torch.int32))
    assert d.shape == (1, 3) and (d == 0).all()
