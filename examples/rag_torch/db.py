"""RAG vector-store helpers over a Collection of the PyTorch port (a copy
of ``examples/rag/db.py`` over ``alayalite_tpu_torch``): chunk text, embed,
insert into a Collection, and query top-k context strings. The collections
live on ``ALAYALITE_DEVICE`` (default ``cuda``).
"""

from __future__ import annotations

import os
import uuid
from typing import List, Optional

from alayalite_tpu_torch import Client, Collection
from alayalite_tpu_torch.rag import BaseEmbedding, get_chunker, get_embedder

_client: Optional[Client] = None


def get_client() -> Client:
    global _client
    if _client is None:
        _client = Client(device=os.environ.get("ALAYALITE_DEVICE"))
    return _client


def get_collection(name: str = "rag") -> Collection:
    return get_client().get_or_create_collection(name)


def insert_text(text: str, collection_name: str = "rag",
                embedder: Optional[BaseEmbedding] = None,
                chunker_name: str = "sentence") -> int:
    """Chunk + embed + insert; returns the number of chunks stored."""
    embedder = embedder or get_embedder("hashing")
    chunks = get_chunker(chunker_name).chunk(text)
    if not chunks:
        return 0
    emb = embedder.embed(chunks)
    col = get_collection(collection_name)
    items = [(str(uuid.uuid4()), chunk, emb[i], {})
             for i, chunk in enumerate(chunks)]
    col.insert(items)
    return len(chunks)


def query_text(question: str, topk: int = 5, collection_name: str = "rag",
               embedder: Optional[BaseEmbedding] = None) -> List[str]:
    """Top-k context chunks for a question."""
    embedder = embedder or get_embedder("hashing")
    col = get_collection(collection_name)
    q = embedder.embed([question])
    res = col.batch_query(q, limit=topk, ef_search=max(topk * 4, 32))
    return res["document"][0]
