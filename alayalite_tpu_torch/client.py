"""Client: a registry of named indices and collections (port of
``alayalite_tpu/client.py``).

With a ``url`` the directory is created if missing and scanned: each
subdirectory whose ``schema.json`` has ``type`` "collection" or "index" is
loaded (directories written by either package). Everything the client
makes or loads lives on its ``device``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Dict, Optional

from .collection import Collection
from .device import DeviceLike, resolve_device
from .index_api import Index
from .params import fill_none_values

log = logging.getLogger("alayalite_tpu_torch")


def _schema_type(directory: str) -> Optional[str]:
    path = os.path.join(directory, "schema.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f).get("type")
    except (OSError, json.JSONDecodeError):
        return None


def is_index_url(directory: str) -> bool:
    return _schema_type(directory) == "index"


def is_collection_url(directory: str) -> bool:
    return _schema_type(directory) == "collection"


class Client:
    def __init__(self, url: Optional[str] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._collections: Dict[str, Collection] = {}
        self._indices: Dict[str, Index] = {}
        self._url: Optional[str] = None
        if url is not None:
            self._url = os.path.abspath(url)
            os.makedirs(self._url, exist_ok=True)
            log.info("loading data from %s", self._url)
            for name in sorted(os.listdir(self._url)):
                full = os.path.join(self._url, name)
                if not os.path.isdir(full):
                    continue
                if is_collection_url(full):
                    self._collections[name] = Collection.load(
                        self._url, name, device=self.device)
                elif is_index_url(full):
                    self._indices[name] = Index.load(self._url, name,
                                                     device=self.device)
                else:
                    log.warning("unknown directory: %s", full)

    # ---- listing / access ----
    def list_collections(self):
        return list(self._collections.keys())

    def list_indices(self):
        return list(self._indices.keys())

    def get_collection(self, name: str = "default") -> Optional[Collection]:
        return self._collections.get(name)

    def get_index(self, name: str = "default") -> Optional[Index]:
        return self._indices.get(name)

    # ---- creation ----
    def _check_free(self, name: str) -> None:
        if name in self._collections or name in self._indices:
            raise RuntimeError(f"'{name}' already exists")

    def create_collection(self, name: str = "default", **kwargs) -> Collection:
        self._check_free(name)
        col = Collection(name, fill_none_values(**kwargs), device=self.device)
        self._collections[name] = col
        return col

    def create_index(self, name: str = "default", **kwargs) -> Index:
        self._check_free(name)
        idx = Index(name, fill_none_values(**kwargs), device=self.device)
        self._indices[name] = idx
        return idx

    def get_or_create_collection(self, name: str, **kwargs) -> Collection:
        if name in self._collections:
            return self._collections[name]
        return self.create_collection(name, **kwargs)

    def get_or_create_index(self, name: str, **kwargs) -> Index:
        if name in self._indices:
            return self._indices[name]
        return self.create_index(name, **kwargs)

    # ---- deletion ----
    def _delete_disk(self, name: str) -> None:
        if self._url is not None:
            full = os.path.join(self._url, name)
            if os.path.exists(full):
                shutil.rmtree(full)

    def delete_collection(self, collection_name: str,
                          delete_on_disk: bool = False) -> None:
        if collection_name not in self._collections:
            raise RuntimeError(f"Collection '{collection_name}' does not exist")
        del self._collections[collection_name]
        if delete_on_disk:
            self._delete_disk(collection_name)

    def delete_index(self, index_name: str,
                     delete_on_disk: bool = False) -> None:
        if index_name not in self._indices:
            raise RuntimeError(f"Index '{index_name}' does not exist")
        del self._indices[index_name]
        if delete_on_disk:
            self._delete_disk(index_name)

    def reset(self, delete_on_disk: bool = False) -> None:
        if delete_on_disk:
            for name in list(self._collections) + list(self._indices):
                self._delete_disk(name)
        self._collections.clear()
        self._indices.clear()

    # ---- persistence ----
    def _save_dir(self, name: str, registry: dict, kind: str) -> str:
        if self._url is None:
            raise RuntimeError("Client is not initialized with a url")
        if name not in registry:
            raise RuntimeError(f"{kind} '{name}' does not exist")
        directory = os.path.join(self._url, name)
        os.makedirs(directory, exist_ok=True)
        return directory

    def save_index(self, index_name: str) -> None:
        directory = self._save_dir(index_name, self._indices, "Index")
        self._indices[index_name].save(directory)

    def save_collection(self, collection_name: str) -> None:
        directory = self._save_dir(collection_name, self._collections,
                                   "Collection")
        self._collections[collection_name].save(directory)
