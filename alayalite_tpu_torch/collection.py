"""Collection: a document table joined to a vector index (port of
``alayalite_tpu/collection.py``, the same API, results and messages).

Items are ``(id, document, embedding, metadata)`` tuples. The table keeps
its columns as lists in row order with a map from id to row, and the
outer-id ↔ inner-index-id maps sit beside it. Every table cost is in the
items a call names, not in the table's size, except where a call reads
every row (a metadata filter) or removes rows (one pass per call): the
JAX package's frame rebuilds an id index on every query, concatenates a
frame per insert and filters the frame once per upserted item.
``reindex`` gathers the live rows from the raw space on the device in one
``index_select`` and fits a new index on them.

On disk a collection directory is an index directory plus
``collection.pkl`` (a pickled pandas DataFrame of the table under
``"dataframe"`` and both maps) with ``schema.json``'s ``type`` set to
``"collection"``: the JAX package's layout, so each package loads the
other's collections. pandas is imported only by ``save`` and ``load``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .index_api import Index
from .params import IndexParams, MetricType

_COLUMNS = ("id", "document", "metadata")


def _assert(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _matches(metadata: dict, metadata_filter: dict) -> bool:
    return all(metadata.get(k) == v for k, v in metadata_filter.items())


class Collection:
    def __init__(self, name: str, index_params: Optional[IndexParams] = None,
                 device: DeviceLike = None):
        self._name = name
        self._index_params = (index_params if index_params is not None
                              else IndexParams())
        self.device = resolve_device(device)
        self._index: Optional[Index] = None
        self._cols: Dict[str, list] = {c: [] for c in _COLUMNS}
        self._row: Dict[object, int] = {}      # id -> row position
        self._outer_inner: Dict[object, int] = {}
        self._inner_outer: Dict[int, object] = {}

    @property
    def name(self) -> str:
        return self._name

    def _rows(self, positions) -> dict:
        return {c: [self._cols[c][p] for p in positions] for c in _COLUMNS}

    # ---- queries ----
    def batch_query(self, vectors, limit: int, ef_search: int = 100,
                    num_threads: int = 1) -> dict:
        _assert(self._index is not None, "Index is not initialized yet")
        v = np.asarray(vectors, dtype=np.float32)
        _assert(v.size > 0, "vectors must not be empty")
        _assert(v.shape[-1] == self._index.get_dim(),
                "Vector dimension must match the index dimension.")
        _assert(ef_search >= limit, "ef_search must be >= limit")
        ids, dists = self._index.batch_search_with_distance(
            np.atleast_2d(v), limit, ef_search, num_threads)
        return self._join_results(ids, dists)

    def _join_results(self, ids, dists) -> dict:
        """Inner-id results → documents, query by query. Ids unknown to
        the collection are dropped together with their distances."""
        ret = {"id": [], "document": [], "metadata": [], "distance": []}
        for row_ids, row_d in zip(np.asarray(ids).tolist(),
                                  np.asarray(dists).tolist()):
            pairs = [(self._inner_outer[i], float(d))
                     for i, d in zip(row_ids, row_d)
                     if i in self._inner_outer]
            sub = self._rows([self._row[u] for u, _ in pairs])
            for c in _COLUMNS:
                ret[c].append(sub[c])
            ret["distance"].append([d for _, d in pairs])
        return ret

    def filter_query(self, metadata_filter: dict,
                     limit: Optional[int] = None) -> dict:
        hits = []
        for p, m in enumerate(self._cols["metadata"]):
            if limit is not None and len(hits) >= limit:
                break
            if _matches(m, metadata_filter):
                hits.append(p)
        return self._rows(hits)

    def get_by_id(self, ids: List[str]) -> dict:
        """The rows of ``ids`` that exist, in table order."""
        return self._rows(sorted({self._row[i] for i in ids
                                  if i in self._row}))

    # ---- mutation ----
    def insert(self, items: List[tuple]) -> None:
        """items: [(id, document, embedding, metadata), ...]."""
        if not items:
            return
        dup = [it[0] for it in items if it[0] in self._outer_inner]
        _assert(not dup, f"ids already exist: {dup[:5]}")
        emb = np.asarray([it[2] for it in items], dtype=np.float32)
        if self._index is None:
            self._index = Index(self._name, self._index_params,
                                device=self.device)
            self._index.fit(emb)
            inner_ids = list(range(len(items)))
        else:
            inner_ids = np.atleast_1d(self._index.insert(emb)).tolist()
        start = len(self._cols["id"])
        for k, ((item_id, document, _e, metadata), inner) in enumerate(
                zip(items, inner_ids)):
            self._cols["id"].append(item_id)
            self._cols["document"].append(document)
            self._cols["metadata"].append(metadata)
            self._row[item_id] = start + k
            self._outer_inner[item_id] = inner
            self._inner_outer[inner] = item_id

    def _drop_rows(self, ids) -> None:
        """Remove the rows of ``ids`` in one pass, keeping the order."""
        gone = set(ids)
        keep = [p for p, i in enumerate(self._cols["id"]) if i not in gone]
        if len(keep) == len(self._cols["id"]):
            return
        self._cols = self._rows(keep)
        self._row = {i: p for p, i in enumerate(self._cols["id"])}

    def _unmap(self, ids) -> list:
        """Drop ``ids`` from both maps; their inner ids, in order."""
        inner = []
        for item_id in ids:
            i = self._outer_inner.pop(item_id, None)
            if i is not None:
                self._inner_outer.pop(i, None)
                inner.append(i)
        return inner

    def upsert(self, items: List[tuple]) -> None:
        """Replace the items whose id exists (one batched remove from the
        index), then insert them after the new ones, as the JAX package
        orders the table."""
        to_update = [it for it in items if it[0] in self._outer_inner]
        to_insert = [it for it in items if it[0] not in self._outer_inner]
        if to_update:
            ids = [it[0] for it in to_update]
            self._index.remove(self._unmap(ids))
            self._drop_rows(ids)
        to_insert += to_update
        if to_insert:
            self.insert(to_insert)

    def delete_by_id(self, ids: List[str]) -> None:
        inner = self._unmap(ids)
        if inner and self._index is not None:
            self._index.remove(inner)
        self._drop_rows(ids)

    def delete_by_filter(self, metadata_filter: dict) -> None:
        self.delete_by_id(self.filter_query(metadata_filter)["id"])

    def reindex(self) -> None:
        """Rebuild the index over the live rows, in table order: row p
        becomes inner id p."""
        if self._index is None or not self._cols["id"]:
            return
        space = self._index._engine.space
        inner = torch.as_tensor([self._outer_inner[i]
                                 for i in self._cols["id"]],
                                dtype=torch.int64, device=space.device)
        embeddings = space.data.index_select(0, inner).float()
        self._index = Index(self._name, self._index_params,
                            device=self.device)
        self._index.fit(embeddings)
        self._outer_inner = {i: p for p, i in enumerate(self._cols["id"])}
        self._inner_outer = {p: i for i, p in self._outer_inner.items()}

    # ---- config ----
    def set_metric(self, metric: str) -> None:
        if self._index is not None:
            raise RuntimeError("Cannot change metric after index is created")
        self._index_params.metric = MetricType.parse(metric)

    def get_index_params(self) -> IndexParams:
        return self._index_params

    # ---- persistence ----
    def save(self, url) -> dict:
        import pandas as pd

        os.makedirs(url, exist_ok=True)
        frame = pd.DataFrame({c: self._cols[c] for c in _COLUMNS},
                             columns=list(_COLUMNS))
        with open(os.path.join(url, "collection.pkl"), "wb") as f:
            pickle.dump({"dataframe": frame,
                         "outer_inner_map": self._outer_inner,
                         "inner_outer_map": self._inner_outer}, f)
        _assert(self._index is not None, "Index is not initialized yet")
        schema = self._index.save(url)
        schema["type"] = "collection"
        with open(os.path.join(url, "schema.json"), "w") as f:
            json.dump(schema, f, indent=4)
        return schema

    @classmethod
    def load(cls, url, name: str, device: DeviceLike = None) -> "Collection":
        import pandas  # noqa: F401  (the pickle holds a DataFrame)

        directory = os.path.join(url, name)
        if not os.path.exists(directory):
            raise RuntimeError(f"Collection {name} does not exist")
        with open(os.path.join(directory, "schema.json")) as f:
            schema = json.load(f)
        if schema.get("type") != "collection":
            raise RuntimeError(f"{name} is not a collection")
        inst = cls(name, device=device)
        with open(os.path.join(directory, "collection.pkl"), "rb") as f:
            data = pickle.load(f)
        frame = data["dataframe"]
        inst._cols = {c: frame[c].tolist() for c in _COLUMNS}
        inst._row = {i: p for p, i in enumerate(inst._cols["id"])}
        inst._outer_inner = dict(data["outer_inner_map"])
        inst._inner_outer = dict(data["inner_outer_map"])
        inst._index = Index.load(url, name, device=inst.device)
        inst._index_params = inst._index.get_params()
        return inst
