"""REST service: the same /api/v1/collection/* contract as the reference
(port of ``alayalite_tpu/service/app.py`` onto the port's ``Client``).

Route-for-route parity with the reference's app/{main.py,routers/client.py}
(status codes included: 409 on create conflict, 404 on missing collection,
400 otherwise, 422 on a malformed request). The app is a framework-free
dispatcher (``ServiceApp.handle``) behind a stdlib ThreadingHTTPServer: one
process, one ``Client`` on ``device`` (``None`` means ``cuda``), its calls
serialized by a lock; the HTTP layer only marshals JSON. With
``ALAYALITE_BATCH_SERVING=1`` queries skip that lock and coalesce across
threads in one ``SearchServer`` per collection.

The storage directory comes from ALAYALITE_DATA_DIR (routers/client.py:28).

    python -m alayalite_tpu_torch.service.app --device cuda --data-dir DIR
        [--host 0.0.0.0] [--port 8000]
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..client import Client
from ..device import DeviceLike
from ..serving import SearchServer
from . import models as m

log = logging.getLogger("alayalite_tpu_torch")

Handler = Callable[[dict], Tuple[int, Any]]


class ServiceApp:
    """Framework-free route table; handle() is directly testable."""

    prefix = "/api/v1"

    def __init__(self, data_dir: Optional[str] = None,
                 device: DeviceLike = None):
        if data_dir is None:
            data_dir = os.environ.get("ALAYALITE_DATA_DIR",
                                      os.path.abspath("./data"))
        os.makedirs(data_dir, exist_ok=True)
        self.client = Client(url=data_dir, device=device)
        self._lock = threading.Lock()
        self._batch_serving = os.environ.get(
            "ALAYALITE_BATCH_SERVING") == "1"
        self._servers = {}
        # dedicated lock for the SearchServer cache: batched queries skip
        # self._lock (they coalesce across threads), so cache get/create/
        # close must have their own guard or two threads can race to create
        # duplicate servers / close one mid-submit
        self._servers_lock = threading.Lock()
        self.routes: Dict[str, Handler] = {
            "/collection/create": self.create_collection,
            "/collection/set_metric": self.set_metric,
            "/collection/list": self.list_collections,
            "/collection/delete": self.delete_collection,
            "/collection/reset": self.reset,
            "/collection/insert": self.insert,
            "/collection/query": self.query,
            "/collection/upsert": self.upsert,
            "/collection/delete_by_id": self.delete_by_id,
            "/collection/delete_by_filter": self.delete_by_filter,
            "/collection/save": self.save,
        }

    # ---- dispatch ----
    def handle(self, method: str, path: str, body: Optional[dict]) -> Tuple[int, Any]:
        if method != "POST":
            return 405, {"error": "method not allowed"}
        if path.startswith(self.prefix):
            path = path[len(self.prefix):]
        fn = self.routes.get(path)
        if fn is None:
            return 404, {"error": f"unknown route {path}"}
        if fn == self.query and self._batch_serving:
            # batched queries coalesce across threads — don't serialize them
            try:
                return fn(body or {})
            except (TypeError, ValueError) as e:
                return 422, {"error": str(e)}
        with self._lock:
            try:
                return fn(body or {})
            except (TypeError, ValueError) as e:  # validation errors
                return 422, {"error": str(e)}

    def _collection(self, name: str):
        col = self.client.get_collection(name)
        if col is None:
            return None, (404, {"error": f"Collection {name} does not exist"})
        return col, None

    # ---- routes (parity: app/routers/client.py:39-179) ----
    def create_collection(self, body: dict) -> Tuple[int, Any]:
        req = m.CreateCollectionRequest(**body)
        try:
            self.client.create_collection(req.collection_name)
            return 200, f"Collection {req.collection_name} created successfully"
        except Exception as e:
            msg = str(e)
            return (409 if "already exists" in msg else 400), {"error": msg}

    def set_metric(self, body: dict) -> Tuple[int, Any]:
        req = m.SetMetricRequest(**body)
        col, err = self._collection(req.collection_name)
        if err:
            return err
        try:
            col.set_metric(req.metric)
        except Exception as e:
            return 400, {"error": str(e)}
        return 200, (f"Metric for collection {req.collection_name} "
                     f"set to {req.metric}")

    def list_collections(self, body: dict) -> Tuple[int, Any]:
        return 200, list(self.client.list_collections())

    def _drop_servers(self, name: str = None) -> None:
        """Close + evict cached SearchServers (all of them when name is
        None) — a deleted collection's server holds a dispatcher thread
        and the old index alive."""
        with self._servers_lock:
            names = [name] if name is not None else list(self._servers)
            dropped = [self._servers.pop(n, None) for n in names]
        for srv in dropped:
            if srv is not None:
                srv.close()

    def delete_collection(self, body: dict) -> Tuple[int, Any]:
        req = m.DeleteCollectionRequest(**body)
        try:
            self.client.delete_collection(req.collection_name,
                                          req.delete_on_disk)
            self._drop_servers(req.collection_name)
            return 200, f"Collection {req.collection_name} deleted successfully"
        except Exception as e:
            msg = str(e)
            return (404 if "does not exist" in msg else 400), {"error": msg}

    def reset(self, body: dict) -> Tuple[int, Any]:
        req = m.ResetCollectionRequest(**body)
        self.client.reset(req.delete_on_disk)
        self._drop_servers()
        return 200, "Collection reset successfully"

    def insert(self, body: dict) -> Tuple[int, Any]:
        req = m.InsertCollectionRequest(**body)
        col, err = self._collection(req.collection_name)
        if err:
            return err
        try:
            col.insert([tuple(it) for it in req.items])
            return 200, (f"Successfully inserted {len(req.items)} items "
                         f"into collection {req.collection_name}")
        except Exception as e:
            return 400, {"error": str(e)}

    def query(self, body: dict) -> Tuple[int, Any]:
        req = m.QueryCollectionRequest(**body)
        col, err = self._collection(req.collection_name)
        if err:
            return err
        try:
            if self._batch_serving:
                result = self._query_batched(col, req)
            else:
                result = col.batch_query(req.query_vector, limit=req.limit,
                                         ef_search=req.ef_search,
                                         num_threads=req.num_threads)
            return 200, result
        except Exception as e:
            return 400, {"error": str(e)}

    def _query_batched(self, col, req):
        """Concurrent micro-batched serving (ALAYALITE_BATCH_SERVING=1):
        requests from all HTTP threads coalesce in the native queue and ride
        one device search, in place of the reference's per-query coroutine
        scheduler. Requests in a batch share the server's ef."""
        qs = np.atleast_2d(np.asarray(req.query_vector, dtype=np.float32))
        dim = col._index.get_dim()
        if qs.shape[-1] != dim:
            raise ValueError(
                "Vector dimension must match the index dimension.")
        name = col.name
        want_ef = max(req.ef_search, req.limit)
        with self._servers_lock:
            srv = self._servers.get(name)
            # rebuild when topk/ef outgrows the cached server (requests in
            # a batch share the server's (topk, ef)), or when the cached
            # server was built for a DIFFERENT index object — a deleted +
            # recreated collection must not serve from the old index
            if (srv is None or srv.topk < req.limit or srv.ef < want_ef
                    or srv._index is not col._index):
                old = self._servers.pop(name, None)
                if old is not None:
                    old.close()
                srv = SearchServer(col._index,
                                   topk=max(req.limit, 10,
                                            old.topk if old else 0),
                                   ef=max(want_ef, old.ef if old else 0),
                                   max_batch=1024, timeout_us=2000)
                self._servers[name] = srv
            # submit under the lock (non-blocking push) so a concurrent
            # rebuild can't close this server mid-submit; only the
            # fut.result() waits happen unlocked
            futs = [srv.submit(q) for q in qs]
        ids = np.stack([f.result()[0][: req.limit] for f in futs])
        dists = np.stack([f.result()[1][: req.limit] for f in futs])
        # the id->document join reads collection state that concurrent
        # insert/upsert (which hold self._lock) mutate non-atomically
        # (_inner_outer is updated before the table) — take the lock for the
        # join so a valid inner id can't miss its document row
        with self._lock:
            return col._join_results(ids, dists)

    def upsert(self, body: dict) -> Tuple[int, Any]:
        req = m.UpsertCollectionRequest(**body)
        col, err = self._collection(req.collection_name)
        if err:
            return err
        try:
            col.upsert([tuple(it) for it in req.items])
            return 200, (f"Successfully upserted {len(req.items)} items "
                         f"into collection {req.collection_name}")
        except Exception as e:
            return 400, {"error": str(e)}

    def delete_by_id(self, body: dict) -> Tuple[int, Any]:
        req = m.DeleteByIdRequest(**body)
        col, err = self._collection(req.collection_name)
        if err:
            return err
        try:
            col.delete_by_id(req.ids)
            return 200, (f"Successfully deleted items from collection "
                         f"{req.collection_name}")
        except Exception as e:
            return 400, {"error": str(e)}

    def delete_by_filter(self, body: dict) -> Tuple[int, Any]:
        req = m.DeleteByFilterRequest(**body)
        col, err = self._collection(req.collection_name)
        if err:
            return err
        try:
            col.delete_by_filter(req.filter)
            return 200, (f"Successfully deleted {len(req.filter)} items "
                         f"from collection {req.collection_name}")
        except Exception as e:
            return 400, {"error": str(e)}

    def save(self, body: dict) -> Tuple[int, Any]:
        req = m.SaveCollectionRequest(**body)
        try:
            self.client.save_collection(req.collection_name)
            return 200, f"Collection {req.collection_name} saved successfully"
        except Exception as e:
            msg = str(e)
            return (404 if "does not exist" in msg else 400), {"error": msg}


def create_app(data_dir: Optional[str] = None,
               device: DeviceLike = None) -> ServiceApp:
    return ServiceApp(data_dir, device=device)


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: more clients connecting at
    # once than that see their connections reset
    request_queue_size = 1024


def make_server(app: ServiceApp, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    """The stdlib HTTP server over ``app`` (port 0 picks a free port:
    ``server_address[1]``); ``serve_forever()`` runs it. HTTP/1.1, so a
    client may keep its connection open across requests; a thread per
    connection."""

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(length) if length else b""
            try:
                body = json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                self._respond(400, {"error": "invalid JSON body"})
                return
            status, payload = app.handle("POST", self.path, body)
            self._respond(status, payload)

        def _respond(self, status: int, payload) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):  # route through logging
            log.info("%s - %s", self.address_string(), fmt % args)

    return _Server((host, port), _Handler)


def serve(host: str = "0.0.0.0", port: int = 8000,
          data_dir: Optional[str] = None, device: DeviceLike = None) -> None:
    """Run the HTTP server (the uvicorn-entrypoint analog, app/main.py)."""
    srv = make_server(create_app(data_dir, device=device), host, port)
    log.info("serving on %s:%d", host, srv.server_address[1])
    srv.serve_forever()


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="alayalite_tpu_torch REST service")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the collections (default cuda)")
    a = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    serve(a.host, a.port, a.data_dir, a.device)
