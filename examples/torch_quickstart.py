"""Quickstart on the PyTorch port: 1k x 128 random vectors, L2, fit +
batch_search top-10, recall printed.

    python examples/torch_quickstart.py [--device cuda|cpu]

The index lives on ``--device`` (default ``cuda``, as every entry point of
the port; ``cpu`` runs the kernels' plain PyTorch versions).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from alayalite_tpu_torch import Client  # noqa: E402
from alayalite_tpu_torch.utils.evaluate import calc_gt, calc_recall  # noqa: E402

p = argparse.ArgumentParser()
p.add_argument("--device", default=None)
device = p.parse_args().device

rng = np.random.default_rng(0)
data = rng.random((1000, 128), dtype=np.float32)
queries = data[:10] + 0.01 * rng.standard_normal((10, 128)).astype(np.float32)

client = Client(device=device)
index = client.create_index("quickstart", index_type="hnsw", capacity=1000)
index.fit(data)

ids = index.batch_search(queries, topk=10, ef_search=64)
gt = calc_gt(data, queries, 10, device=device)
print(f"recall@10 = {calc_recall(ids, gt):.3f}")
print(f"top-1 ids  = {ids[:, 0].tolist()}")
