"""Online serving: concurrent micro-batching in front of the batched search
(port of ``alayalite_tpu/serving.py``).

The reference serves concurrent queries by spawning one C++20 coroutine per
query on a pinned-worker Scheduler (its include/executor/
scheduler.hpp:39-222, python/include/index.hpp:289-448). Here many client
threads each submit one query; the native queue (``native.BatchQueue``)
coalesces them into a batch with bounded added latency; one dispatcher
thread runs that batch as one device search
(``IndexEngine.batch_search_with_distance``) and scatters the rows back to
per-request futures. The queries stay host float32 rows until the batch is
moved to the device once, inside the search; a batch of any size is one
call (nothing is padded).
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

import numpy as np

from .native import BatchQueue


def _index_dim(index) -> Optional[int]:
    if hasattr(index, "get_dim"):
        return index.get_dim()
    return index.space.dim if index.space is not None else None


class SearchServer:
    """Wraps an Index (or IndexEngine) with a concurrent search() API.

    search() is thread-safe and blocking; under concurrency, requests
    coalesce into batches of up to ``max_batch`` with at most ``timeout_us``
    of added latency. Requests in one batch share the server's topk / ef.
    """

    def __init__(self, index, topk: int = 10, ef: int = 100,
                 max_batch: int = 1024, timeout_us: int = 2000):
        dim = _index_dim(index)
        if dim is None:
            raise RuntimeError("index must be fitted before serving")
        self._index = index
        self.topk = topk
        self.ef = ef
        self._queue = BatchQueue(dim, capacity=8 * max_batch,
                                 max_batch=max_batch, timeout_us=timeout_us)
        self._futures: Dict[int, Future] = {}
        self._futures_lock = threading.Lock()
        self._ticket = itertools.count()
        self._closed = False
        self.batches = 0        # batches popped and searched
        self.queries = 0        # queries in them
        self.search_s = 0.0     # seconds the dispatcher spent searching them
        self._dispatcher = threading.Thread(target=self._run, daemon=True)
        self._dispatcher.start()

    # ---- client side ----
    def search(self, query: np.ndarray, topk: Optional[int] = None,
               ef: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking single-query search; safe from any thread. ``ef`` is
        the server's; asking for a ``topk`` above the server's width is an
        error, not a silent truncation."""
        del ef
        k = topk or self.topk
        if k > self.topk:
            raise ValueError(
                f"topk={k} exceeds this server's batch width "
                f"(topk={self.topk}); create the SearchServer with a "
                f"larger topk")
        ids, dists = self.submit(query).result()
        return ids[:k], dists[:k]

    def submit(self, query: np.ndarray) -> Future:
        if self._closed:
            raise RuntimeError("server closed")
        t = next(self._ticket)
        fut: Future = Future()
        with self._futures_lock:
            self._futures[t] = fut
        self._queue.push(t, np.asarray(query, dtype=np.float32))
        return fut

    # ---- dispatcher ----
    def _search(self, batch: np.ndarray):
        engine = getattr(self._index, "_engine", self._index)
        return engine.batch_search_with_distance(batch, self.topk,
                                                 ef=self.ef)

    def _run(self) -> None:
        while True:
            batch, tickets = self._queue.pop_batch()
            if batch is None:
                break
            self.batches += 1
            self.queries += batch.shape[0]
            t = time.perf_counter()
            try:
                ids, dists = self._search(batch)
                err = None
            except Exception as e:  # reaches every waiter of this batch
                ids = dists = None
                err = e
            self.search_s += time.perf_counter() - t
            with self._futures_lock:
                futs = [self._futures.pop(int(t), None) for t in tickets]
            for row, fut in enumerate(futs):
                if fut is None:
                    continue
                # a caller may have cancel()ed its future; set_* would then
                # raise InvalidStateError and kill this dispatcher thread,
                # hanging every later search
                try:
                    if err is not None:
                        fut.set_exception(err)
                    else:
                        fut.set_result((ids[row], dists[row]))
                except Exception:
                    pass
        # queue closed: fail every future still waiting so no client hangs
        with self._futures_lock:
            leftovers = list(self._futures.values())
            self._futures.clear()
        for fut in leftovers:
            try:
                if not fut.done():
                    fut.set_exception(RuntimeError("server closed"))
            except Exception:  # cancelled between done() and set_exception
                pass

    def close(self) -> None:
        self._closed = True
        self._queue.close()
        self._dispatcher.join(timeout=10)
