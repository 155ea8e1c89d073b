"""Text embedders for RAG (port of ``alayalite_tpu/rag/embedder.py``).

Capability parity with the reference's python/src/alayalite/rag/embedder/
(BaseEmbedding + Bge/M3e/Multilingual/Jina wrappers and get_embedder,
embedder.py:28-50). One generic ``TransformersEmbedding`` covers all four
reference wrappers (they differ only in model id and pooling); it imports
``transformers`` only when built and runs its model on ``device``
(``None`` means ``cuda``, as every entry point of the port). The
network-free ``HashingEmbedding`` is host code and serves tests and offline
demos.
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod
from typing import List, Sequence

import numpy as np

from ..device import DeviceLike, resolve_device

# model ids matching the reference's named wrappers
MODEL_ALIASES = {
    "bge": "BAAI/bge-base-en-v1.5",
    "m3e": "moka-ai/m3e-base",
    "multilingual": "intfloat/multilingual-e5-base",
    "jina": "jinaai/jina-embeddings-v2-base-en",
}


class BaseEmbedding(ABC):
    @abstractmethod
    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """[n, dim] float32."""

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.embed(texts)

    @property
    @abstractmethod
    def dim(self) -> int:
        ...


class HashingEmbedding(BaseEmbedding):
    """Deterministic char-n-gram hashing embedding (offline; no weights).

    Not a neural model — a stable, similarity-preserving-enough featurizer
    for tests, demos, and environments without model downloads.
    """

    def __init__(self, dim: int = 256, ngram: int = 3):
        self._dim = dim
        self.ngram = ngram

    @property
    def dim(self) -> int:
        return self._dim

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self._dim), dtype=np.float32)
        for i, t in enumerate(texts):
            t = t.lower()
            for j in range(max(len(t) - self.ngram + 1, 1)):
                g = t[j: j + self.ngram]
                h = int.from_bytes(
                    hashlib.blake2b(g.encode(), digest_size=8).digest(),
                    "little")
                out[i, h % self._dim] += 1.0 if (h >> 63) else -1.0
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-30)


class TransformersEmbedding(BaseEmbedding):
    """Mean-pooled HF transformer embeddings (Bge/M3e/Multilingual/Jina
    analog). Requires model weights to be available locally or downloadable."""

    def __init__(self, model_name: str = "bge", device: DeviceLike = None,
                 max_length: int = 512):
        model_name = MODEL_ALIASES.get(model_name, model_name)
        device = resolve_device(device)
        try:
            from transformers import AutoModel, AutoTokenizer
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("transformers is required for "
                               "TransformersEmbedding") from e
        try:
            self.tokenizer = AutoTokenizer.from_pretrained(model_name)
            self.model = AutoModel.from_pretrained(model_name).to(device)
        except Exception as e:
            raise RuntimeError(
                f"could not load embedding model {model_name!r} (offline "
                f"environment? pre-download weights or use "
                f"HashingEmbedding): {e}") from e
        self.model.eval()
        self.device = device
        self.max_length = max_length
        self._dim = int(self.model.config.hidden_size)

    @property
    def dim(self) -> int:
        return self._dim

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        import torch

        with torch.no_grad():
            enc = self.tokenizer(list(texts), padding=True, truncation=True,
                                 max_length=self.max_length,
                                 return_tensors="pt").to(self.device)
            out = self.model(**enc).last_hidden_state          # [n, T, H]
            mask = enc["attention_mask"].unsqueeze(-1).float()
            emb = (out * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
            emb = torch.nn.functional.normalize(emb, dim=-1)
        return emb.cpu().numpy().astype(np.float32)


def get_embedder(name: str = "hashing", **kwargs) -> BaseEmbedding:
    """Factory (reference: embedder.py get_embedder)."""
    name_l = name.lower()
    if name_l == "hashing":
        return HashingEmbedding(**kwargs)
    return TransformersEmbedding(model_name=name, **kwargs)
