"""RAG helpers: chunkers and embedders (port of ``alayalite_tpu/rag``)."""

from .chunker import (BaseChunker, FixedSizeChunker, SemanticChunker,
                      SentenceChunker, get_chunker)
from .embedder import (BaseEmbedding, HashingEmbedding, TransformersEmbedding,
                       get_embedder)

__all__ = [
    "BaseChunker",
    "BaseEmbedding",
    "FixedSizeChunker",
    "HashingEmbedding",
    "SemanticChunker",
    "SentenceChunker",
    "TransformersEmbedding",
    "get_chunker",
    "get_embedder",
]
