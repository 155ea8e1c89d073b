"""The port's REST service (``alayalite_tpu_torch/service/app.py``) over
every route on the CPU: the cases of tests/test_service.py (the direct
dispatcher, one real-socket pass through the port's own stdlib server, the
batched mode), and data directories shared with the JAX package's service
in both directions."""

import http.client
import json
import threading

import numpy as np
import pytest

from alayalite_tpu_torch.native import get_lib
from alayalite_tpu_torch.service.app import ServiceApp, create_app, make_server


@pytest.fixture()
def app(tmp_path):
    return create_app(str(tmp_path), device="cpu")


def _items(n, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    return [[i, f"doc {i}", emb[i].tolist(), {"even": i % 2 == 0}]
            for i in range(n)], emb


def test_create_conflict_and_list(app):
    s, body = app.handle("POST", "/api/v1/collection/create",
                         {"collection_name": "c"})
    assert s == 200
    s, body = app.handle("POST", "/api/v1/collection/create",
                         {"collection_name": "c"})
    assert s == 409
    s, body = app.handle("POST", "/api/v1/collection/list", {})
    assert s == 200 and body == ["c"]
    assert app.client.device.type == "cpu"


def test_insert_query_upsert_delete_cycle(app):
    app.handle("POST", "/api/v1/collection/create", {"collection_name": "c"})
    items, emb = _items(32)
    s, body = app.handle("POST", "/api/v1/collection/insert",
                         {"collection_name": "c", "items": items})
    assert s == 200, body
    s, res = app.handle("POST", "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": emb[:2].tolist(),
        "limit": 3, "ef_search": 10})
    assert s == 200
    assert res["id"][0][0] == 0 and res["id"][1][0] == 1
    assert len(res["distance"][0]) == 3

    s, _ = app.handle("POST", "/api/v1/collection/upsert", {
        "collection_name": "c",
        "items": [[0, "updated", np.full(8, 5.0).tolist(), {}]]})
    assert s == 200
    s, res = app.handle("POST", "/api/v1/collection/query", {
        "collection_name": "c",
        "query_vector": [np.full(8, 5.0).tolist()], "limit": 1,
        "ef_search": 10})
    assert res["document"][0][0] == "updated"

    s, _ = app.handle("POST", "/api/v1/collection/delete_by_id",
                      {"collection_name": "c", "ids": [0]})
    assert s == 200
    s, _ = app.handle("POST", "/api/v1/collection/delete_by_filter",
                      {"collection_name": "c", "filter": {"even": True}})
    assert s == 200
    s, res = app.handle("POST", "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": emb[:4].tolist(),
        "limit": 3, "ef_search": 10})
    assert s == 200 and all(i % 2 == 1 for row in res["id"] for i in row)
    s, body = app.handle("POST", "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": [[1.0]], "limit": 1})
    assert s == 400 and "dimension" in body["error"]
    s, body = app.handle("POST", "/api/v1/collection/query",
                         {"collection_name": "c", "limit": 1})
    assert s == 422


def test_missing_collection_404(app):
    for route, extra in [
        ("insert", {"items": []}),
        ("query", {"query_vector": [[0.0]], "limit": 1}),
        ("upsert", {"items": []}),
        ("delete_by_id", {"ids": [1]}),
        ("delete_by_filter", {"filter": {}}),
        ("set_metric", {"metric": "l2"}),
    ]:
        s, body = app.handle("POST", f"/api/v1/collection/{route}",
                             {"collection_name": "nope", **extra})
        assert s == 404, (route, s, body)
    s, _ = app.handle("POST", "/api/v1/collection/save",
                      {"collection_name": "nope"})
    assert s == 404


def test_save_and_reload(tmp_path, monkeypatch):
    """Saved, then served by a second app that finds the directory through
    ALAYALITE_DATA_DIR."""
    app = create_app(str(tmp_path), device="cpu")
    app.handle("POST", "/api/v1/collection/create", {"collection_name": "c"})
    items, emb = _items(16)
    app.handle("POST", "/api/v1/collection/insert",
               {"collection_name": "c", "items": items})
    s, _ = app.handle("POST", "/api/v1/collection/save",
                      {"collection_name": "c"})
    assert s == 200
    monkeypatch.setenv("ALAYALITE_DATA_DIR", str(tmp_path))
    app2 = ServiceApp(device="cpu")
    s, res = app2.handle("POST", "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": emb[:1].tolist(),
        "limit": 1, "ef_search": 10})
    assert s == 200 and res["id"][0][0] == 0


def test_reset_and_delete(app):
    app.handle("POST", "/api/v1/collection/create", {"collection_name": "a"})
    s, _ = app.handle("POST", "/api/v1/collection/delete",
                      {"collection_name": "a"})
    assert s == 200
    s, _ = app.handle("POST", "/api/v1/collection/delete",
                      {"collection_name": "a"})
    assert s == 404
    app.handle("POST", "/api/v1/collection/create", {"collection_name": "b"})
    s, _ = app.handle("POST", "/api/v1/collection/set_metric",
                      {"collection_name": "b", "metric": "ip"})
    assert s == 200
    s, _ = app.handle("POST", "/api/v1/collection/reset", {})
    assert s == 200
    s, names = app.handle("POST", "/api/v1/collection/list", {})
    assert names == []


def test_unknown_route_and_method(app):
    s, _ = app.handle("POST", "/api/v1/collection/nope", {})
    assert s == 404
    s, _ = app.handle("GET", "/api/v1/collection/list", {})
    assert s == 405


def _post(port, path, payload, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, raw if raw is not None else json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def test_http_socket_roundtrip(tmp_path):
    """Real sockets through the port's own stdlib server (make_server, the
    handler ``serve()`` runs): create, insert, query, a bad JSON body."""
    app = create_app(str(tmp_path), device="cpu")
    srv = make_server(app, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    try:
        s, body = _post(port, "/api/v1/collection/create",
                        {"collection_name": "c"})
        assert s == 200 and b"created successfully" in body
        items, emb = _items(24)
        s, _ = _post(port, "/api/v1/collection/insert",
                     {"collection_name": "c", "items": items})
        assert s == 200
        s, body = _post(port, "/api/v1/collection/query", {
            "collection_name": "c", "query_vector": emb[:3].tolist(),
            "limit": 2, "ef_search": 10})
        assert s == 200
        assert [r[0] for r in json.loads(body)["id"]] == [0, 1, 2]
        s, body = _post(port, "/api/v1/collection/list", None, raw="{bad")
        assert s == 400 and b"invalid JSON" in body
        # HTTP/1.1: one connection carries several requests
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        for _ in range(3):
            conn.request("POST", "/api/v1/collection/list", "{}",
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read()) == ["c"]
        conn.close()
        # more clients connecting at once than socketserver's default
        # backlog of 5
        statuses = []

        def client(_):
            statuses.append(_post(port, "/api/v1/collection/list", {})[0])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(64)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert statuses == [200] * 64
    finally:
        srv.shutdown()
        srv.server_close()


needs_native = pytest.mark.skipif(get_lib() is None,
                                  reason="native toolchain unavailable")


@needs_native
def test_batched_serving_mode(tmp_path, monkeypatch):
    """ALAYALITE_BATCH_SERVING=1: concurrent queries coalesce through the
    native queue and match the direct path."""
    monkeypatch.setenv("ALAYALITE_BATCH_SERVING", "1")
    app = create_app(str(tmp_path), device="cpu")
    app.handle("POST", "/api/v1/collection/create", {"collection_name": "c"})
    items, emb = _items(48)
    app.handle("POST", "/api/v1/collection/insert",
               {"collection_name": "c", "items": items})

    results = {}

    def worker(lo, hi):
        for i in range(lo, hi):
            s, res = app.handle("POST", "/api/v1/collection/query", {
                "collection_name": "c", "query_vector": [emb[i].tolist()],
                "limit": 1, "ef_search": 10})
            results[i] = (s, res["id"][0][0] if s == 200 else None)

    ts = [threading.Thread(target=worker, args=(t * 8, t * 8 + 8))
          for t in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(results[i] == (200, i) for i in range(32)), results
    s, _ = app.handle("POST", "/api/v1/collection/delete",
                      {"collection_name": "c"})
    assert s == 200 and "c" not in app._servers


@needs_native
def test_batched_serving_ef_upgrade_and_bad_dim(tmp_path, monkeypatch):
    """A later request with a larger ef_search rebuilds the cached server,
    and a wrong-dimension query is a 400 that never reaches the queue."""
    monkeypatch.setenv("ALAYALITE_BATCH_SERVING", "1")
    app = create_app(str(tmp_path), device="cpu")
    app.handle("POST", "/api/v1/collection/create", {"collection_name": "c"})
    items, emb = _items(48)
    app.handle("POST", "/api/v1/collection/insert",
               {"collection_name": "c", "items": items})

    s, _ = app.handle("POST", "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": [emb[0].tolist()],
        "limit": 1, "ef_search": 10})
    assert s == 200
    srv1 = app._servers["c"]
    assert srv1.ef == 10

    s, _ = app.handle("POST", "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": [emb[0].tolist()],
        "limit": 1, "ef_search": 40})
    assert s == 200
    srv2 = app._servers["c"]
    assert srv2 is not srv1 and srv2.ef >= 40

    s, body = app.handle("POST", "/api/v1/collection/query", {
        "collection_name": "c", "query_vector": [[1.0, 2.0]],
        "limit": 1, "ef_search": 40})
    assert s == 400 and "dimension" in str(body)
    assert app._servers["c"] is srv2


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b)
                          for a, b in zip(ids, gt)]))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_data_dir_shared_with_the_jax_service(tmp_path, direction):
    """A data directory that one package's service saved (a flat and an
    hnsw collection) is served by the other's: the same ids for flat, and
    recall@10 within 0.02 of the writer's for hnsw."""
    from alayalite_tpu.service.app import create_app as jax_create_app

    make = {"jax": lambda: jax_create_app(str(tmp_path)),
            "port": lambda: create_app(str(tmp_path), device="cpu")}
    src_kind, dst_kind = direction.split("_to_")
    src = make[src_kind]()
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(8, 16)) * 4.0
    emb = (centers[rng.integers(0, 8, 600)]
           + rng.normal(size=(600, 16))).astype(np.float32)
    queries = emb[:40] + 0.1 * rng.normal(size=(40, 16)).astype(np.float32)
    d = ((queries[:, None, :] - emb[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1, kind="stable")[:, :10]
    items = [[i, f"doc {i}", emb[i].tolist(), {"s": i % 3}]
             for i in range(600)]
    src.client.create_collection("flat", index_type="flat", capacity=1000)
    src.client.create_collection("graph", capacity=1000, max_nbrs=16)
    want = {}
    for name in ("flat", "graph"):
        s, _ = src.handle("POST", "/api/v1/collection/insert",
                          {"collection_name": name, "items": items})
        assert s == 200
        s, _ = src.handle("POST", "/api/v1/collection/save",
                          {"collection_name": name})
        assert s == 200
        s, want[name] = src.handle("POST", "/api/v1/collection/query", {
            "collection_name": name, "query_vector": queries.tolist(),
            "limit": 10, "ef_search": 64})
        assert s == 200
    dst = make[dst_kind]()
    s, names = dst.handle("POST", "/api/v1/collection/list", {})
    assert sorted(names) == ["flat", "graph"]
    for name in ("flat", "graph"):
        s, got = dst.handle("POST", "/api/v1/collection/query", {
            "collection_name": name, "query_vector": queries.tolist(),
            "limit": 10, "ef_search": 64})
        assert s == 200
        if name == "flat":
            assert got["id"] == want["flat"]["id"]
            np.testing.assert_allclose(got["distance"],
                                       want["flat"]["distance"],
                                       rtol=1e-5, atol=1e-3)
        else:
            r_got, r_want = _recall(got["id"], gt), _recall(want[name]["id"],
                                                            gt)
            assert r_got >= r_want - 0.02, (r_got, r_want)
        for ids, docs in zip(got["id"], got["document"]):
            assert docs == [f"doc {i}" for i in ids]
