"""The PyTorch port stands alone: it never imports JAX or the JAX package,
its parameters serialize exactly like the JAX package's, and its entry
points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import alayalite_tpu.params as jax_params
import alayalite_tpu_torch.params as torch_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "alayalite_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "alayalite_tpu")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_import_leaves_no_jax_in_sys_modules():
    """Nor pandas or h5py: the collection imports pandas only to save and
    load, the dataset loaders h5py only to read an hdf5 file."""
    code = ("import sys, alayalite_tpu_torch, alayalite_tpu_torch.convert, "
            "alayalite_tpu_torch.index.qg, alayalite_tpu_torch.ops._build, "
            "alayalite_tpu_torch.index.overlay_update, "
            "alayalite_tpu_torch.collection, alayalite_tpu_torch.client, "
            "alayalite_tpu_torch.utils.io, alayalite_tpu_torch.utils.datasets, "
            "alayalite_tpu_torch.utils.evaluate, "
            "alayalite_tpu_torch.ops.hadamard, "
            "alayalite_tpu_torch.spaces.rabitq\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED + ('pandas', 'h5py')!r})\n"
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_banned_import_in_sources():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    scripts = os.path.join(ROOT, "scripts")
    files += [os.path.join(scripts, f) for f in os.listdir(scripts)
              if f.startswith("torch_") and f.endswith(".py")]
    assert os.path.join(scripts, "torch_pallas_bench.py") in files
    assert len(files) > 20
    for path in files:
        assert not (_imported_roots(path) & set(BANNED)), path


@pytest.mark.parametrize("kwargs", [
    {},
    dict(index_type="hnsw", quantization_type="bsq8", max_nbrs=32,
         ef_construction=200, prune_alpha=1.2, seed_sample=16384,
         beam_expand=8, capacity=1_000_000),
    dict(metric="cos", quantization_type="bsq8", capacity=1200, max_nbrs=16),
])
def test_params_json_identical(kwargs):
    a = jax_params.fill_none_values(**kwargs).to_json()
    b = torch_params.fill_none_values(**kwargs).to_json()
    assert a == b
    assert torch_params.IndexParams.from_json(a).to_json() == a


def test_entry_points_default_to_cuda(tmp_path):
    import numpy as np

    from alayalite_tpu_torch import Client, Collection
    from alayalite_tpu_torch.index.engine import IndexEngine
    from alayalite_tpu_torch.utils.evaluate import calc_gt

    params = torch_params.IndexParams(quantization_type="bsq8")
    x = np.eye(4, 8, dtype=np.float32)
    if torch.cuda.is_available():
        assert Client().device.type == "cuda"
        assert IndexEngine(params).device.type == "cuda"
        assert Collection("c").device.type == "cuda"
        assert (calc_gt(x, x, 1)[:, 0] == np.arange(4)).all()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Client()
        with pytest.raises(RuntimeError, match="CUDA"):
            Client(url=str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            IndexEngine(params)
        with pytest.raises(RuntimeError, match="CUDA"):
            Collection("c")
        with pytest.raises(RuntimeError, match="CUDA"):
            calc_gt(x, x, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            calc_gt(x, x, 2, fast=True)
    assert Client(device="cpu").device.type == "cpu"
    assert Client(url=str(tmp_path), device="cpu").list_indices() == []
    assert Collection("c", device="cpu").device.type == "cpu"
    for fast in (False, True):
        assert (calc_gt(x, x, 1, fast=fast, device="cpu")[:, 0]
                == np.arange(4)).all()


def test_unported_surfaces_raise():
    from alayalite_tpu_torch import Client

    c = Client(device="cpu")
    # every index of the single-device JAX package is ported but flat +
    # sq4; sharding still waits, naming its ROADMAP item
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        c.create_index("flat4", index_type="flat", quantization_type="sq4")
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        c.create_index("shards", index_type="flat", db_shards=2)
    for shards in ("build_shards", "serve_shards"):
        with pytest.raises(NotImplementedError, match="queue 1, item 6"):
            c.create_index("shards", index_type="hnsw", **{shards: 2})
    c.create_collection("col").insert(
        [("a", "doc", torch.ones(8).numpy(), {})])
    c.create_index("u8", index_type="flat", data_type="uint8")
    c.create_index("f16", storage_dtype="float16")
    for kind, quant in (("hnsw", "none"), ("nsg", "none"),
                        ("fusion", "none"), ("hnsw", "rabitq"),
                        ("hnsw", "rabitq2")):
        idx = c.create_index(f"{kind}_{quant}", index_type=kind,
                             quantization_type=quant, capacity=300,
                             max_nbrs=8)
        idx.fit(torch.randn(200, 8).numpy())
        assert idx.insert(torch.zeros(8).numpy()) == 200
        idx.remove([1])
