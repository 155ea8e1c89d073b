"""RaBitQ on the card: the hop's estimate (``estimate_many``, one
``block_diagdot`` launch) against the same space on the CPU, and a small
rabitq / rabitq2 index fitted on the card answering as its copy loaded on
the CPU. No JAX import, so the file runs where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_rabitq_card.py``.
Tolerance: 1e-3 of the estimates' scale (the dot's f32 sums in another
order)."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch import Index, IndexParams
from alayalite_tpu_torch.ops.diagdot import block_diagdot
from alayalite_tpu_torch.spaces.rabitq import RaBitQSpace
from alayalite_tpu_torch.utils.datasets import random_dataset
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 2])
def test_cuda_estimate_many_matches_cpu(bits):
    _need_card()
    rng = np.random.default_rng(bits)
    data = rng.normal(size=(3000, 128)).astype(np.float32)
    nbrs = rng.integers(-1, 3000, size=(3000, 32)).astype(np.int32)
    cpu = RaBitQSpace.create(3000, 128, bits=bits).fit(data)
    cpu.update_neighbors(nbrs)
    card = RaBitQSpace.load_arrays(cpu.save_arrays(),
                                   device=torch.device("cuda"))
    q = torch.as_tensor(rng.normal(size=(512, 128)).astype(np.float32))
    u = torch.as_tensor(rng.integers(0, 3000, size=(512, 8)))
    want_e, want_i = cpu.estimate_many(cpu.query_ctx(q), u)
    launches = block_diagdot.launches
    got_e, got_i = card.estimate_many(card.query_ctx(q.cuda()), u.cuda())
    torch.cuda.synchronize()
    assert block_diagdot.launches == launches + 1
    assert torch.equal(got_i.cpu(), want_i)
    scale = float(want_e.abs().max())
    assert float((got_e.cpu() - want_e).abs().max()) <= 1e-3 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["rabitq", "rabitq2"])
def test_cuda_rabitq_index_agrees_with_cpu(tmp_path, quant):
    _need_card()
    ds = random_dataset(n=4000, dim=64, n_queries=256, seed=3)
    gt = calc_gt(ds.data, ds.queries, 10, device="cpu")
    card = Index("r", IndexParams(quantization_type=quant, capacity=4100,
                                  ef_construction=64))
    card.fit(ds.data)
    card.save(str(tmp_path / "r"))
    cpu = Index.load(str(tmp_path), "r", device="cpu")
    ids_g = card.batch_search(ds.queries, 10, ef_search=32)
    ids_c = cpu.batch_search(ds.queries, 10, ef_search=32)
    assert (ids_g == ids_c).mean() >= 0.98
    assert abs(calc_recall(ids_g, gt) - calc_recall(ids_c, gt)) <= 0.01
    assert calc_recall(ids_g, gt) >= 0.9
    new = card.insert(ds.data[:32] + 0.01)
    assert (card.batch_search(ds.data[:32] + 0.01, 1, ef_search=64)[:, 0]
            == new).mean() >= 0.95
