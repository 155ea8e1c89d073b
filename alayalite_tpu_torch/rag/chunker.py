"""Text chunkers for RAG ingestion (a copy of
``alayalite_tpu/rag/chunker.py``; host code).

Capability parity with the reference's python/src/alayalite/rag/chunker/
(BaseChunker + FixSize/Sentence/Semantic strategies and the get_chunker
factory, chunker.py:31-52). Semantic chunking accepts any embedding callable
(the reference hard-wires sentence-transformers).
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Sequence

import numpy as np


class BaseChunker(ABC):
    @abstractmethod
    def chunk(self, text: str) -> List[str]:
        ...

    def chunk_many(self, texts: Sequence[str]) -> List[str]:
        out: List[str] = []
        for t in texts:
            out.extend(self.chunk(t))
        return out


class FixedSizeChunker(BaseChunker):
    """Character windows with overlap (FixSizeChunker analog)."""

    def __init__(self, chunk_size: int = 512, overlap: int = 64):
        if overlap >= chunk_size:
            raise ValueError("overlap must be smaller than chunk_size")
        self.chunk_size = chunk_size
        self.overlap = overlap

    def chunk(self, text: str) -> List[str]:
        if not text:
            return []
        step = self.chunk_size - self.overlap
        return [text[i: i + self.chunk_size]
                for i in range(0, max(len(text) - self.overlap, 1), step)]


_SENTENCE_RE = re.compile(r"(?<=[.!?。！？])\s+")


class SentenceChunker(BaseChunker):
    """Sentence-boundary splits packed up to ``max_chars``."""

    def __init__(self, max_chars: int = 512):
        self.max_chars = max_chars

    def chunk(self, text: str) -> List[str]:
        sentences = [s.strip() for s in _SENTENCE_RE.split(text) if s.strip()]
        chunks: List[str] = []
        cur = ""
        for s in sentences:
            if cur and len(cur) + len(s) + 1 > self.max_chars:
                chunks.append(cur)
                cur = s
            else:
                cur = f"{cur} {s}".strip()
        if cur:
            chunks.append(cur)
        return chunks


class SemanticChunker(BaseChunker):
    """Merge adjacent sentences while embedding similarity stays above a
    threshold (SemanticChunker analog; embedder-agnostic)."""

    def __init__(self, embed: Callable[[List[str]], np.ndarray],
                 similarity_threshold: float = 0.6, max_chars: int = 1024):
        self.embed = embed
        self.similarity_threshold = similarity_threshold
        self.max_chars = max_chars

    def chunk(self, text: str) -> List[str]:
        sentences = [s.strip() for s in _SENTENCE_RE.split(text) if s.strip()]
        if len(sentences) <= 1:
            return sentences
        emb = np.asarray(self.embed(sentences), dtype=np.float32)
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True),
                               1e-30)
        sims = (emb[:-1] * emb[1:]).sum(axis=1)
        chunks: List[str] = []
        cur = sentences[0]
        for s, sim in zip(sentences[1:], sims):
            if sim >= self.similarity_threshold and \
                    len(cur) + len(s) + 1 <= self.max_chars:
                cur = f"{cur} {s}"
            else:
                chunks.append(cur)
                cur = s
        chunks.append(cur)
        return chunks


def get_chunker(name: str = "fixed", **kwargs) -> BaseChunker:
    """Factory (reference: chunker.py get_chunker)."""
    name = name.lower()
    if name in ("fixed", "fix_size", "fixsize"):
        return FixedSizeChunker(**kwargs)
    if name == "sentence":
        return SentenceChunker(**kwargs)
    if name == "semantic":
        return SemanticChunker(**kwargs)
    raise ValueError(f"unknown chunker {name!r}")
