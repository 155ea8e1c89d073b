"""Request models for the REST service (a copy of
``alayalite_tpu/service/models.py``).

Field-for-field parity with the reference's app/models/collection.py:21-68 so
clients of the reference service work unchanged. Uses pydantic when present,
with a minimal fallback class without it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

try:
    from pydantic import BaseModel
except ImportError:  # pragma: no cover - pydantic is expected to exist
    class BaseModel:  # type: ignore[no-redef]
        def __init__(self, **kw):
            for k, v in kw.items():
                setattr(self, k, v)


class CreateCollectionRequest(BaseModel):
    collection_name: str


class SetMetricRequest(BaseModel):
    collection_name: str
    metric: str


class DeleteCollectionRequest(BaseModel):
    collection_name: str
    delete_on_disk: bool = False


class ResetCollectionRequest(BaseModel):
    delete_on_disk: bool = False


class InsertCollectionRequest(BaseModel):
    collection_name: str
    items: List[Tuple[int, str, List[float], Dict[str, Any]]]


class UpsertCollectionRequest(BaseModel):
    collection_name: str
    items: List[Tuple[int, str, List[float], Dict[str, Any]]]


class QueryCollectionRequest(BaseModel):
    collection_name: str
    query_vector: List[List[float]]
    limit: int = 1
    ef_search: int = 10
    num_threads: int = 1


class DeleteByIdRequest(BaseModel):
    collection_name: str
    ids: List[int]


class DeleteByFilterRequest(BaseModel):
    collection_name: str
    filter: Dict[str, Any]


class SaveCollectionRequest(BaseModel):
    collection_name: str
