"""OpenAI-compatible chat call for the PyTorch port's RAG demo (a copy of
``examples/rag/llm.py``).

Capability parity with the reference's examples/rag/llm.py: POST
/v1/chat/completions against any OpenAI-compatible endpoint, with the
retrieved context stuffed into the system prompt. Uses stdlib HTTP (no
``openai`` package needed).
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import List, Optional

DEFAULT_BASE_URL = os.environ.get("OPENAI_BASE_URL", "http://localhost:8001/v1")
DEFAULT_MODEL = os.environ.get("OPENAI_MODEL", "gpt-4o-mini")

SYSTEM_TEMPLATE = (
    "You are a helpful assistant. Answer using ONLY the context below.\n"
    "Context:\n{context}"
)


def chat(question: str, context_chunks: List[str],
         base_url: str = DEFAULT_BASE_URL, model: str = DEFAULT_MODEL,
         api_key: Optional[str] = None, temperature: float = 0.2) -> str:
    api_key = api_key or os.environ.get("OPENAI_API_KEY", "none")
    payload = {
        "model": model,
        "temperature": temperature,
        "messages": [
            {"role": "system",
             "content": SYSTEM_TEMPLATE.format(context="\n---\n".join(context_chunks))},
            {"role": "user", "content": question},
        ],
    }
    req = urllib.request.Request(
        f"{base_url.rstrip('/')}/chat/completions",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {api_key}"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    return body["choices"][0]["message"]["content"]
