"""Streamlit RAG demo UI on the PyTorch port (a copy of
``examples/rag/ui.py``).

Run: ``streamlit run examples/rag_torch/ui.py`` (requires streamlit; the
db/llm layers below it need no more than the port).
"""

from __future__ import annotations

try:
    import streamlit as st
except ImportError as e:  # pragma: no cover
    raise SystemExit("streamlit is not installed in this environment; "
                     "use examples/rag_torch/db.py + llm.py directly") from e

from db import insert_text, query_text
from llm import chat

st.title("alayalite_tpu_torch RAG demo")

with st.sidebar:
    st.header("Ingest")
    doc = st.text_area("Paste a document")
    if st.button("Insert") and doc:
        n = insert_text(doc)
        st.success(f"inserted {n} chunks")

question = st.text_input("Ask a question")
if st.button("Answer") and question:
    ctx = query_text(question, topk=5)
    st.subheader("Retrieved context")
    for c in ctx:
        st.markdown(f"> {c}")
    try:
        st.subheader("Answer")
        st.write(chat(question, ctx))
    except Exception as e:
        st.warning(f"LLM call failed ({e}); showing retrieval only")
