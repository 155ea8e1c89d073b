import numpy as np
import pytest
import torch

from portbench import reference


def _brute(x, q, k, metric="l2"):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "l2":
        d = ((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    else:
        d = 1.0 - (q64 @ x64.T) / np.outer(np.linalg.norm(q64, axis=1),
                                          np.linalg.norm(x64, axis=1))
    i = np.argsort(d, axis=1, kind="stable")[:, :k]
    return i, np.take_along_axis(d, i, 1)


@pytest.mark.parametrize("n,dim,k", [(500, 16, 10), (3000, 128, 10),
                                     (40, 8, 10)])
def test_exact_knn_matches_numpy_brute_force(n, dim, k):
    g = np.random.default_rng(n)
    c = g.normal(size=(8, dim)) * 4
    x = (c[g.integers(0, 8, n)] + g.normal(size=(n, dim))).astype(np.float32)
    q = (x[g.integers(0, n, 50)] + 0.25 * g.normal(size=(50, dim))
         ).astype(np.float32)
    got = reference.knn(torch.as_tensor(x), torch.as_tensor(q), k)
    i, d = _brute(x, q, k)
    assert np.array_equal(got.ids.numpy(), i)
    assert np.allclose(got.dists.numpy(), d, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("metric", ["cos", "L2"])
def test_exact_knn_under_each_metric_matches_numpy(metric):
    g = np.random.default_rng(17)
    c = g.normal(size=(8, 32)) * 4
    x = (c[g.integers(0, 8, 2000)] + g.normal(size=(2000, 32))
         ).astype(np.float32)
    q = (c[g.integers(0, 8, 60)] + g.normal(size=(60, 32))
         ).astype(np.float32)
    got = reference.knn(torch.as_tensor(x), torch.as_tensor(q), 10, metric)
    i, d = _brute(x, q, 10, metric.lower())
    assert np.array_equal(got.ids.numpy(), i)
    assert np.allclose(got.dists.numpy(), d, rtol=1e-12, atol=1e-9)


def test_a_metric_the_reference_does_not_compute_is_refused():
    x = torch.zeros((4, 2))
    for metric in ("ip", "hamming"):
        with pytest.raises(ValueError, match="no metric"):
            reference.knn(x, x, 2, metric)
        with pytest.raises(ValueError, match="no metric"):
            reference.exact_f64(x, x[None], metric)


def test_shortlist_fallback_scores_every_row():
    # all rows at one distance but for a few: the shortlist's last float32
    # distance ties the k-th, so the fallback rescans in float64
    x = np.zeros((200, 4), dtype=np.float32)
    x[:, 0] = 1.0
    x[150:, 0] = 1.0 + np.arange(50, dtype=np.float32) * 1e-7
    q = np.zeros((1, 4), dtype=np.float32)
    got = reference.knn(torch.as_tensor(x), torch.as_tensor(q), 10)
    i, _ = _brute(x, q, 10)
    assert np.array_equal(got.ids.numpy(), i)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.14159265, -2.5e-3])
    r = reference.round_tf32(x)
    assert r[0] == x[0]                        # representable in TF32
    assert r[1] == 1.0                         # below half an ulp: dropped
    m = r.view(torch.int32) & 0x1FFF
    assert bool((m == 0).all())
    assert torch.allclose(r, x, rtol=2 ** -11)


def test_tf32_control_misorders_near_ties():
    g = np.random.default_rng(3)
    c = g.normal(size=(4, 128)) * 4
    x = (c[g.integers(0, 4, 4000)] + g.normal(size=(4000, 128))
         ).astype(np.float32)
    q = (x[:200] + 0.25 * g.normal(size=(200, 128))).astype(np.float32)
    ex = reference.knn(torch.as_tensor(x), torch.as_tensor(q), 10)
    ctl = reference.knn_tf32(torch.as_tensor(x), torch.as_tensor(q), 10)
    assert not torch.equal(ex.ids, ctl.ids)


@pytest.mark.gpu
def test_tf32_control_on_the_card_misorders_near_ties(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    c = torch.randn((4, 128), generator=g, device=cuda) * 4
    x = c[torch.randint(0, 4, (20000,), generator=g, device=cuda)]
    x += torch.randn(x.shape, generator=g, device=cuda)
    q = x[:500] + 0.25 * torch.randn((500, 128), generator=g, device=cuda)
    ex = reference.knn(x, q, 10)
    ctl = reference.knn_tf32(x, q, 10)
    assert not torch.equal(ex.ids, ctl.ids)
    assert not torch.backends.cuda.matmul.allow_tf32     # restored
