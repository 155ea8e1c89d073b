"""The port's RAG helpers (``alayalite_tpu_torch/rag``): the cases of
tests/test_rag.py on the CPU, the chunkers and the hashing embedding
against the JAX package's on the same text, and TransformersEmbedding's
device default (cuda; it raises without one, before any model load)."""

import numpy as np
import pytest
import torch

from alayalite_tpu_torch.rag import (FixedSizeChunker, HashingEmbedding,
                                     SemanticChunker, SentenceChunker,
                                     TransformersEmbedding, get_chunker,
                                     get_embedder)

TEXT = ("The eiffel tower is in paris. Bananas are yellow fruit! "
        "Jax compiles numpy-like programs. Is the cat on the mat? "
        "The cat sat on the mat. " * 3)


def test_fixed_size_chunker_overlap():
    c = FixedSizeChunker(chunk_size=10, overlap=4)
    chunks = c.chunk("abcdefghijklmnopqrstuvwxyz")
    assert all(len(ch) <= 10 for ch in chunks)
    assert chunks[0][-4:] == chunks[1][:4]
    assert "".join(ch[:6] for ch in chunks).startswith("abcdef")
    with pytest.raises(ValueError):
        FixedSizeChunker(chunk_size=4, overlap=4)


def test_sentence_chunker_packs():
    text = "One. Two! Three? Four."
    c = SentenceChunker(max_chars=12)
    chunks = c.chunk(text)
    assert len(chunks) >= 2
    assert all(len(ch) <= 12 for ch in chunks)
    assert " ".join(chunks).replace("  ", " ").count("One") == 1


def test_semantic_chunker_merges_similar():
    emb = HashingEmbedding(dim=64)
    c = SemanticChunker(embed=emb.embed, similarity_threshold=0.5)
    text = ("the cat sat on the mat. the cat sat on a mat. "
            "quantum chromodynamics is a gauge theory.")
    chunks = c.chunk(text)
    assert 1 <= len(chunks) <= 3
    assert sum("cat" in ch for ch in chunks) == 1


def test_hashing_embedding_properties():
    e = HashingEmbedding(dim=128)
    v = e.embed(["hello world", "hello world", "completely different text"])
    assert v.shape == (3, 128)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(v[0], v[1])
    assert v[0] @ v[2] < 0.9


def test_factories():
    assert isinstance(get_chunker("sentence"), SentenceChunker)
    assert isinstance(get_chunker("fixed", chunk_size=8, overlap=2),
                      FixedSizeChunker)
    assert isinstance(get_embedder("hashing"), HashingEmbedding)
    with pytest.raises(ValueError):
        get_chunker("nope")


def test_rag_end_to_end():
    """chunk → embed → Collection insert (cos, flat, on the CPU) → the
    right chunk comes back."""
    import uuid

    from alayalite_tpu_torch import Collection, IndexParams

    emb = HashingEmbedding(dim=128)
    chunks = SentenceChunker(max_chars=60).chunk(
        "The eiffel tower is in paris. Bananas are yellow fruit. "
        "Jax compiles numpy-like programs to TPUs.")
    vecs = emb.embed(chunks)
    col = Collection("rag", IndexParams(index_type="flat", capacity=64,
                                        metric="cos"), device="cpu")
    col.insert([(str(uuid.uuid4()), c, vecs[i], {})
                for i, c in enumerate(chunks)])
    q = emb.embed(["where is the eiffel tower?"])
    res = col.batch_query(q, limit=1, ef_search=8)
    assert "eiffel" in res["document"][0][0].lower()


@pytest.mark.parametrize("name,kw", [
    ("fixed", dict(chunk_size=40, overlap=8)),
    ("sentence", dict(max_chars=50)),
    ("semantic", dict(similarity_threshold=0.3, max_chars=90)),
])
def test_matches_jax_package(name, kw):
    """Each chunker, and the hashing embedding, give the JAX package's
    output on the same text."""
    from alayalite_tpu.rag import HashingEmbedding as JaxHashing
    from alayalite_tpu.rag import get_chunker as jax_get_chunker

    if name == "semantic":
        kw = dict(kw, embed=HashingEmbedding(dim=64).embed)
    ours, theirs = get_chunker(name, **kw), jax_get_chunker(name, **kw)
    chunks = ours.chunk(TEXT)
    assert chunks == theirs.chunk(TEXT) and chunks
    np.testing.assert_array_equal(HashingEmbedding(dim=96).embed(chunks),
                                  JaxHashing(dim=96).embed(chunks))


def test_transformers_embedding_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default names it")
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformersEmbedding("bge")
