"""The REST service over the port's ``Client`` (port of
``alayalite_tpu/service``)."""

from .app import ServiceApp, create_app, serve

__all__ = ["ServiceApp", "create_app", "serve"]
