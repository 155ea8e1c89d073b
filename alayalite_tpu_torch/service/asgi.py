"""ASGI surface over the service dispatcher (port of
``alayalite_tpu/service/asgi.py``).

The reference ships a FastAPI app (app/main.py:5-16,
app/routers/client.py:39-179). The canonical app is the framework-free
``ServiceApp`` (service/app.py) behind a stdlib HTTP server; the ASGI
contract exists so deployments that have fastapi/uvicorn can mount the
service unchanged. Two adapters:

  - ``make_asgi(service)``: a dependency-free ASGI-3 callable wrapping
    ``ServiceApp.handle``; works under any ASGI server and under
    ``httpx.ASGITransport``. Handler work runs in a thread executor so a
    query waiting on the device never stalls the event loop.
  - ``create_fastapi_app(data_dir)``: imports fastapi and builds a
    route-for-route FastAPI app (same paths, same pydantic request models
    as the reference's app/models/collection.py) delegating to the same
    ``ServiceApp``. Raises ImportError when fastapi is absent.

``create_asgi_app(data_dir)`` picks FastAPI when available, else the
dependency-free adapter; either way the routes and status codes are those
of ``ServiceApp.handle``. Each takes the port's ``device`` (``None`` means
``cuda``).
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Callable, Optional

from ..device import DeviceLike
from .app import ServiceApp


def make_asgi(service: ServiceApp) -> Callable:
    """Wrap a ServiceApp as a plain ASGI-3 application."""

    async def app(scope: dict, receive: Callable, send: Callable) -> None:
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":  # pragma: no cover - ws not served
            raise RuntimeError(f"unsupported scope type {scope['type']!r}")

        body = b""
        while True:
            msg = await receive()
            body += msg.get("body", b"")
            if not msg.get("more_body", False):
                break
        try:
            payload = json.loads(body) if body else None
        except ValueError:
            status, resp = 400, {"error": "invalid JSON body"}
        else:
            loop = asyncio.get_running_loop()
            status, resp = await loop.run_in_executor(
                None, service.handle, scope["method"], scope["path"], payload)

        data = json.dumps(resp).encode()
        await send({"type": "http.response.start", "status": status,
                    "headers": [(b"content-type", b"application/json"),
                                (b"content-length",
                                 str(len(data)).encode())]})
        await send({"type": "http.response.body", "body": data})

    return app


def create_fastapi_app(data_dir: Optional[str] = None,
                       service: Optional[ServiceApp] = None,
                       device: DeviceLike = None) -> Any:
    """Route-for-route FastAPI app over ServiceApp (reference
    app/main.py:5-16). ImportError when fastapi is not installed —
    callers fall back to ``make_asgi``/the stdlib server."""
    from fastapi import FastAPI  # raises ImportError when absent
    from fastapi.responses import JSONResponse

    from . import models as m

    svc = (service if service is not None
           else ServiceApp(data_dir, device=device))
    app = FastAPI(title="AlayaLite-TPU-torch", version="0.1.0")
    app.state.service = svc

    def _route(path: str, model: type):
        async def endpoint(req: model):  # type: ignore[valid-type]
            payload = (req.model_dump() if hasattr(req, "model_dump")
                       else dict(req.__dict__))
            loop = asyncio.get_running_loop()
            status, resp = await loop.run_in_executor(
                None, svc.handle, "POST", ServiceApp.prefix + path, payload)
            return JSONResponse(status_code=status, content=resp)

        app.post(ServiceApp.prefix + path)(endpoint)

    _route("/collection/create", m.CreateCollectionRequest)
    _route("/collection/set_metric", m.SetMetricRequest)
    _route("/collection/delete", m.DeleteCollectionRequest)
    _route("/collection/reset", m.ResetCollectionRequest)
    _route("/collection/insert", m.InsertCollectionRequest)
    _route("/collection/query", m.QueryCollectionRequest)
    _route("/collection/upsert", m.UpsertCollectionRequest)
    _route("/collection/delete_by_id", m.DeleteByIdRequest)
    _route("/collection/delete_by_filter", m.DeleteByFilterRequest)
    _route("/collection/save", m.SaveCollectionRequest)

    @app.post(ServiceApp.prefix + "/collection/list")
    async def list_collections() -> Any:
        loop = asyncio.get_running_loop()
        status, resp = await loop.run_in_executor(
            None, svc.handle, "POST",
            ServiceApp.prefix + "/collection/list", {})
        return JSONResponse(status_code=status, content=resp)

    return app


def create_asgi_app(data_dir: Optional[str] = None,
                    device: DeviceLike = None) -> Callable:
    """The best available ASGI app: FastAPI when installed, else the
    dependency-free adapter. Same routes/status codes either way."""
    svc = ServiceApp(data_dir, device=device)
    try:
        return create_fastapi_app(service=svc)
    except ImportError:
        return make_asgi(svc)
