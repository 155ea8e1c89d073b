"""The port's ASGI surface (``alayalite_tpu_torch/service/asgi.py``) runs
the route matrix of tests/test_service_asgi.py on the CPU, through
httpx.ASGITransport, and through FastAPI where that package is
installed."""

import asyncio

import httpx
import numpy as np
import pytest

from alayalite_tpu_torch.service.app import ServiceApp
from alayalite_tpu_torch.service.asgi import (create_asgi_app,
                                              create_fastapi_app, make_asgi)


@pytest.fixture(params=["plain", "fastapi"])
def asgi(request, tmp_path):
    svc = ServiceApp(str(tmp_path), device="cpu")
    if request.param == "fastapi":
        pytest.importorskip("fastapi")
        return create_fastapi_app(service=svc)
    return make_asgi(svc)


def post(app, path, payload):
    async def go():
        transport = httpx.ASGITransport(app=app)
        async with httpx.AsyncClient(transport=transport,
                                     base_url="http://svc") as c:
            r = await c.post(path, json=payload)
            return r.status_code, r.json()

    return asyncio.run(go())


def _items(n, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    return [[i, f"doc {i}", emb[i].tolist(), {"even": i % 2 == 0}]
            for i in range(n)], emb


def test_create_conflict_list_delete(asgi):
    s, _ = post(asgi, "/api/v1/collection/create", {"collection_name": "c"})
    assert s == 200
    s, _ = post(asgi, "/api/v1/collection/create", {"collection_name": "c"})
    assert s == 409
    s, body = post(asgi, "/api/v1/collection/list", {})
    assert s == 200 and body == ["c"]
    s, _ = post(asgi, "/api/v1/collection/delete", {"collection_name": "c"})
    assert s == 200
    s, _ = post(asgi, "/api/v1/collection/delete", {"collection_name": "c"})
    assert s == 404


def test_insert_query_cycle(asgi):
    post(asgi, "/api/v1/collection/create", {"collection_name": "c"})
    items, emb = _items(32)
    s, body = post(asgi, "/api/v1/collection/insert",
                   {"collection_name": "c", "items": items})
    assert s == 200, body
    s, res = post(asgi, "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": emb[:2].tolist(),
        "limit": 3, "ef_search": 10})
    assert s == 200
    assert res["id"][0][0] == 0 and res["id"][1][0] == 1
    assert len(res["distance"][0]) == 3

    s, _ = post(asgi, "/api/v1/collection/upsert", {
        "collection_name": "c",
        "items": [[0, "updated", np.full(8, 5.0).tolist(), {}]]})
    assert s == 200
    s, res = post(asgi, "/api/v1/collection/query", {
        "collection_name": "c",
        "query_vector": [np.full(8, 5.0).tolist()], "limit": 1,
        "ef_search": 10})
    assert s == 200 and res["document"][0][0] == "updated"

    s, _ = post(asgi, "/api/v1/collection/delete_by_id",
                {"collection_name": "c", "ids": [1]})
    assert s == 200
    s, res = post(asgi, "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": emb[1:2].tolist(),
        "limit": 1, "ef_search": 10})
    assert s == 200 and res["id"][0][0] != 1


def test_missing_collection_and_bad_route(asgi):
    s, _ = post(asgi, "/api/v1/collection/query", {
        "collection_name": "nope", "query_vector": [[0.0] * 8],
        "limit": 1, "ef_search": 10})
    assert s == 404

    async def raw404():
        transport = httpx.ASGITransport(app=asgi)
        async with httpx.AsyncClient(transport=transport,
                                     base_url="http://svc") as c:
            r = await c.post("/api/v1/collection/nothing", json={})
            return r.status_code

    assert asyncio.run(raw404()) == 404


def test_create_asgi_app_serves_and_defaults_to_cuda(tmp_path):
    """create_asgi_app picks the adapter fastapi's absence leaves, on the
    named device; with no device it means cuda and raises without one."""
    import torch

    app = create_asgi_app(str(tmp_path), device="cpu")
    s, _ = post(app, "/api/v1/collection/create", {"collection_name": "c"})
    assert s == 200
    s, body = post(app, "/api/v1/collection/list", {})
    assert s == 200 and body == ["c"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_asgi_app(str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            ServiceApp(str(tmp_path))
