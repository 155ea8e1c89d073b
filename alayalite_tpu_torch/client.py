"""Client: a registry of named indices (port of the thin part of
``client.py``). Collections and the disk discovery of ``url`` wait in
ROADMAP queue 1, item 3.
"""

from __future__ import annotations

from typing import Dict, Optional

from .device import DeviceLike, resolve_device
from .index_api import Index
from .params import fill_none_values


class Client:
    def __init__(self, url: Optional[str] = None, device: DeviceLike = None):
        if url is not None:
            raise NotImplementedError(
                "Client(url=...) disk discovery is not ported yet "
                "(ROADMAP queue 1, item 3)")
        self.device = resolve_device(device)
        self._indices: Dict[str, Index] = {}

    def get_index(self, name: str = "default") -> Optional[Index]:
        return self._indices.get(name)

    def create_index(self, name: str = "default", **kwargs) -> Index:
        if name in self._indices:
            raise RuntimeError(f"'{name}' already exists")
        idx = Index(name, fill_none_values(**kwargs), device=self.device)
        self._indices[name] = idx
        return idx

    def create_collection(self, name: str = "default", **kwargs):
        raise NotImplementedError(
            "collections are not ported yet (ROADMAP queue 1, item 3)")
