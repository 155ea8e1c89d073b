"""Captured slices: the port's counterpart of JAX's ``jit``.

The JAX package runs a search, a build phase's chunk and an insert batch
as one compiled program each: its loops are ``lax.while_loop``s and
``lax.scan``s on the device, and the engine pads a batch to a fixed bucket
(``_BATCH_BUCKETS``) so that few shapes are compiled. The port runs the
same loops from Python, tens of small launches a hop or a greedy step.
Here each slice is captured once into a ``torch.cuda.CUDAGraph`` and
replayed:

``run(name, fn, inputs, reads, static)`` calls ``fn(*inputs)``, a function
of tensors whose rows are independent (every input and output is [B, ...]
with the same B, and row b of an output depends on row b of the inputs
only). On the card:

  - the first call of a key pads B to its bucket (``bucket``), runs ``fn``
    once on a side stream (this builds the kernels, runs each launcher's
    ``cudaFuncSetAttribute`` and makes every lazily built table outside the
    capture), then captures it (``capture_error_mode="thread_local"``:
    serving has other threads) into the device's one memory pool;
  - every call copies the inputs into the graph's static buffers (rows past
    B are zero), replays the graph and clones the first B rows of each
    output. The three steps run under one lock, and each replay waits for
    the previous one, on whatever stream it ran: the graphs share one pool,
    so two replays must never overlap on the card;
  - a capture that fails raises with its CUDA error. Nothing runs the slice
    uncaptured in its place.

``run_chunks`` drives a build phase's chunk loop through ``run``: the
chunk's row ids are an input (the chunks have one shape, the tail one
overlapping the one before), so one graph serves every chunk of a phase.
``run_inplace(name, fn, inputs, idle, writes, reads, static)`` serves the
inserts' connect steps, which write the space's slabs and the adjacency in
place and whose rows are not independent: nothing is padded (the caller
pads to its bucket), and the warm-up runs ``fn`` on ``idle``, inputs of the
same shapes under which it writes nothing (every row masked), so the state
is written once, by the replay. It also serves the build's loops whose
steps are not independent (NN-Descent's rounds, the repair's loops): their
state goes in as inputs, which ``fn`` updates in place in the graph's own
buffers and returns (JAX's donated buffers), and ``warm``, a cheaper call
that launches every kind of kernel ``fn`` does (part of one chunk of a
round, on scratch state), takes the warm-up's place.

On a CPU tensor, inside ``eager()``, inside another capture or replay, or
where a tensor that ``fn`` reads lies on another device than the inputs
(the distributed beam of ``parallel/dist_graph`` across cards), ``fn`` is
called as it is. ``eager()`` is how a comparison runs a search, a fit or an
insert uncaptured: ``with captured.eager(): eng.fit(x)`` runs every slice
of the fit as plain launches, on this thread only (a ``SearchServer``'s
dispatcher thread keeps replaying), and the kernels' counters count them
as launched.

The key of a graph holds ``name``, ``static`` (the Python values the caller
fixes: k, ef, M, max_iters, ...), the padded B, each input's trailing shape
(``run_inplace``: its whole shape) and dtype, TF32's switch, and the state
of ``reads`` (and ``writes``): each tensor's ``data_ptr()``, shape, strides
and dtype, and each scalar field of a dataclass in it. Capture freezes
scalars into the graph, so a key that missed one would replay stale work.
The scalars the captured code reads, audited:

  search.py           B, k, ef, M, max_iters, visited_mode, exact_rerank
                      (``static``); ``space.capacity`` (a shape);
                      ``space.metric`` (``exact_rescore``); ``nseed``;
  spaces/raw.py       ``capacity``, ``bf16``, ``metric``;
  spaces/sq.py        ``capacity``, ``bits`` (``levels``), ``dim``,
                      ``metric``;
  spaces/bqg.py       ``capacity``, ``dim`` / ``code_dim`` (shapes),
                      ``metric`` (the estimate's coefficient and clamp);
  spaces/rabitq.py    ``capacity``, ``bits``, ``code_dim`` (shapes);
  parallel/dist_graph ``DistSlab.n_total``, ``metric``;
  prune.py            r, alpha (its ``passes``), bf16 (``static``; bf16 is
                      the default in every phase); ``space.metric``;
  build_phases.py     r, alpha, ef (``static``), the chunk (a shape);
  nndescent.py        s_rev, chunk, n, k (``static``); s1, s2, n_rand,
                      the chunks and the anchors (shapes);
  repair_dev.py       ``LOOP_CHUNK``, tile, metric (``static``); n, r and
                      the representatives (shapes);
  fused_insert.py     r, w, row_w, alpha, chunk, ``MATES``,
                      ``TOUCHED_CHUNK`` (``static``); B and the capacity
                      (shapes); ``space.metric``; the bsq8 space's
                      ``ENCODE_CHUNK`` and ``degree`` (set_neighbor_rows'
                      slices, a shape) and ``metric`` (``store_sq``);
  ops/*.py            routes and vector-load switches from shapes and from
                      the operands' ``data_ptr() % 16`` (pointers in the
                      key, or buffers of the graph itself).

``num`` is the one scalar field left out: no captured code reads it (an
insert's bump slots are worked out on the host from ``num`` and the
capacity and go in as an input, and the append is an eager copy), and an
insert in place moves it, so the graph of a grown index is kept. A slab that is
reallocated (fit, load, compact, a new ``valid`` or seed sample) changes a
pointer and so the key.

The kernels' counters (``.calls``, ``.launches``, ``.route_launches``),
the RaBitQ hop's (``spaces/rabitq.counters``) and the tiled scans'
(``ops/distance.counters``) are Python integers that a
replay does not touch: the layer records each counter's change during a
capture, takes it back (nothing ran), and adds it again on every replay, so
a count read around a search stays the count of the work that ran.
``stats`` counts captures, their seconds and replays. While spans are
recorded (``trace``), each replay is a span ``alaya.captured.replay``
(lock, copy-in, replay, clones) and a capture a span
``alaya.captured.capture`` inside it; both are host code outside any
capture.

A device keeps at most ``MAX_GRAPHS`` graphs, the least recently used
dropped first; at its next search it drops every graph whose first read
tensor (the space's slab) has been freed. The graphs of a device share
one memory pool (``torch.cuda.graph_pool_handle()``), which is safe
because replays never overlap and outputs are cloned before the lock is
released; the pool holds the largest slice's temporaries, not their sum.

``scope()`` is a context manager for the build: graphs captured inside it
(on its thread) are kept in the scope, not on the device, in a memory
pool of the scope's own (one a device), and when it closes it drops them,
and with them their pool, whose memory it hands back to the card
(``torch.cuda.empty_cache()``, after a device sync; only where the scope
captured a graph). A builder's ``PhaseTimer`` runs each phase in a scope
of its own, so a fit's graphs (every phase of ``build_phases``, the
build's beam searches, NN-Descent, the repair) live as long as their
phase, as JAX frees a jitted phase's temporaries when the call returns;
searches outside any scope keep the device's pool and its LRU. Scopes
nest: a graph goes to the innermost.

Each capture enters ``torch.cuda.graph``, which syncs the device and
empties the allocator's cache, so the warm-up's temporaries (cached on
the side stream) are freed before the graph's pool grows, and each phase
frees its pool when it ends. On an H100, a 1M-row fit whose captures
skipped the sync and the emptying peaked 7.8-9.3 GiB higher in reserved
memory, and one whose phases shared one pool, freed when the fit ended,
4.1-5.1 GiB higher (PERF.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch

from .. import trace

Tensor = torch.Tensor
BATCH_BUCKETS = (64, 256, 1024, 4096, 16384)   # the JAX engine's buckets
MAX_GRAPHS = 64            # graphs kept per device
_NOT_READ = frozenset({"num"})

_lock = threading.RLock()
_tls = threading.local()
_devices: Dict[torch.device, "_DeviceState"] = {}
stats = {"captures": 0, "capture_s": 0.0, "replays": 0}


def bucket(b: int) -> int:
    """The JAX engine's batch bucket of ``b`` rows: the first of
    ``BATCH_BUCKETS`` that holds it, past the last a multiple of 4096."""
    for s in BATCH_BUCKETS:
        if b <= s:
            return s
    return -(-b // 4096) * 4096


def slice_rows(nq: int, max_slice: int) -> Tuple[int, int]:
    """(rows a slice, padded batch) as the JAX engine pads a batch of
    ``nq`` queries: slices of min(max_slice, bucket(nq)) rows, the batch
    rounded up to a whole number of them."""
    qchunk = min(int(max_slice), bucket(nq))
    return qchunk, -(-nq // qchunk) * qchunk


def pad_rows(x: Tensor, b: int, value=0) -> Tensor:
    """``x`` with rows of ``value`` appended up to ``b`` rows."""
    if x.shape[0] == b:
        return x
    pad = torch.full((b - x.shape[0], *x.shape[1:]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def _walk(x, tensors: list):
    """The key of ``x`` (tensors, dataclasses, sequences, scalars), with
    every tensor appended to ``tensors``."""
    if isinstance(x, Tensor):
        tensors.append(x)
        return ("T", x.data_ptr(), tuple(x.shape), tuple(x.stride()),
                x.dtype, x.device)
    if x is None or isinstance(x, (bool, int, float, str)):
        return (type(x).__name__, x)
    if isinstance(x, (tuple, list)):
        return tuple(_walk(v, tensors) for v in x)
    if dataclasses.is_dataclass(x):
        return (type(x).__qualname__,
                tuple((f.name, _walk(getattr(x, f.name), tensors))
                      for f in dataclasses.fields(x)
                      if f.name not in _NOT_READ))
    raise TypeError(f"cannot key a captured search on {type(x).__name__}")


def _counted() -> tuple:
    from ..ops.diagdot import block_diagdot
    from ..ops.gather_diagdot import gather_diagdot, gather_estimate
    from ..ops.gather_dot import gather_dot
    from ..ops.l2_tile import l2_tile
    from ..ops.pool_sort import pool_merge, roll_n, sort_kv
    from ..ops.ring_probe import ring_probe
    from ..ops.seed_scan import seed_scan
    from ..ops.sq8_tile import sq8_tile
    from ..ops.tile_topk import tile_topk
    from ..ops.unique_topk import unique_topk

    return (block_diagdot, gather_diagdot, gather_estimate, gather_dot,
            l2_tile, tile_topk, pool_merge, roll_n, sort_kv,
            ring_probe, seed_scan, sq8_tile, unique_topk)


def counts() -> dict:
    """Every kernel counter: {(wrapper, attribute, route or None): n}; and
    the RaBitQ hop's and the tiled scans', {(counters, field, None): n}."""
    from ..ops.distance import counters as scan
    from ..spaces.rabitq import counters as rabitq

    out = {}
    for fn in _counted():
        for attr in ("calls", "launches"):
            out[(fn, attr, None)] = getattr(fn, attr)
        for route, n in getattr(fn, "route_launches", {}).items():
            out[(fn, "route_launches", route)] = n
    for c in (rabitq, scan):
        for attr in c.FIELDS:
            out[(c, attr, None)] = getattr(c, attr)
    return out


def _add(delta: dict, sign: int) -> None:
    for (fn, attr, route), n in delta.items():
        if route is None:
            setattr(fn, attr, getattr(fn, attr) + sign * n)
        else:
            fn.route_launches[route] += sign * n


class _DeviceState:
    def __init__(self, dev: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(dev)     # warm-up and capture
        self.done = torch.cuda.Event()
        self.entries: Dict[tuple, "_Entry"] = {}


@dataclasses.dataclass
class _Entry:
    graph: "torch.cuda.CUDAGraph"
    static_in: Tuple[Tensor, ...]
    static_out: Tuple[Tensor, ...]
    delta: dict
    owner: Callable


def _state(dev: torch.device) -> _DeviceState:
    st = _devices.get(dev)
    if st is None:
        st = _devices[dev] = _DeviceState(dev)
    for key in [k for k, e in st.entries.items() if e.owner() is None]:
        del st.entries[key]
    return st


class _Scope:
    """The graphs captured inside one ``scope()`` and a memory pool for
    each device: a context manager."""

    def __init__(self):
        self.entries: Dict[torch.device, Dict[tuple, _Entry]] = {}
        self.pools: Dict[torch.device, tuple] = {}

    def where(self, dev: torch.device) -> Tuple[dict, tuple]:
        if dev not in self.pools:
            self.pools[dev] = torch.cuda.graph_pool_handle()
            self.entries[dev] = {}
        return self.entries[dev], self.pools[dev]

    def __enter__(self) -> "_Scope":
        _scopes().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _scopes().remove(self)
        if not any(self.entries.values()):
            return
        for dev in self.entries:
            torch.cuda.synchronize(dev)      # no replay of these in flight
        with _lock:
            self.entries.clear()
            self.pools.clear()
        torch.cuda.empty_cache()             # the pools' memory to the card


def _scopes() -> list:
    if not hasattr(_tls, "scopes"):
        _tls.scopes = []
    return _tls.scopes


def scope() -> _Scope:
    """Graphs captured inside go, with their memory pool, when it closes
    (see the module's docstring)."""
    return _Scope()


def clear() -> None:
    """Drop every captured graph held on a device (their pool goes with
    the last one); the graphs of an open scope stay."""
    with _lock:
        for st in _devices.values():
            st.entries.clear()


def held() -> list:
    """The names of the graphs held: on the devices, then in open scopes."""
    names = [k[0] for st in _devices.values() for k in st.entries]
    for sc in _scopes():
        names += [k[0] for ents in sc.entries.values() for k in ents]
    return names


def cached() -> int:
    """Graphs held, over all devices and this thread's open scopes."""
    return len(held())


def _capture(st: _DeviceState, pool, fn, static_in: Tuple[Tensor, ...],
             owner, warm=None) -> _Entry:
    """Warm ``fn`` up on ``static_in`` (or call ``warm``) on the side
    stream (these launches run and count), then capture it on the same
    buffers into ``pool``."""
    dev = static_in[0].device
    cur = torch.cuda.current_stream(dev)
    st.side.wait_stream(cur)
    with torch.cuda.stream(st.side):
        if warm is None:
            fn(*static_in)                    # warm-up: these launches ran
        else:
            warm()
    cur.wait_stream(st.side)
    graph = torch.cuda.CUDAGraph()
    before = counts()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=st.side,
                              capture_error_mode="thread_local"):
            outs = fn(*static_in)
    finally:
        after = counts()
        delta = {k: after[k] - n for k, n in before.items()
                 if after[k] != n}
        _add(delta, -1)                       # a capture launches nothing
    stats["captures"] += 1
    stats["capture_s"] += time.perf_counter() - t0
    return _Entry(graph, static_in, tuple(outs), delta,
                  weakref.ref(static_in[0] if owner is None else owner))


@contextlib.contextmanager
def eager():
    """Inside (on this thread), ``run``, ``run_chunks`` and ``run_inplace``
    call ``fn`` as it is: no key, no capture, no replay (see the module's
    docstring). Scopes nest."""
    _tls.eager = getattr(_tls, "eager", 0) + 1
    try:
        yield
    finally:
        _tls.eager -= 1


def _uncaptured(dev: torch.device) -> bool:
    return (dev.type != "cuda" or getattr(_tls, "eager", 0) > 0
            or torch.cuda.is_current_stream_capturing())


def _replay(dev, key, make, inputs: Tuple[Tensor, ...], B: int,
            cut: bool = True) -> Tuple[Tensor, ...]:
    """Under the lock: the entry of ``key`` (``make(st, pool)`` captures
    it on a miss; in the innermost open scope if there is one), the inputs
    copied into its buffers (where ``cut``, rows past B zeroed), one
    replay, and every output cloned (its first B rows where ``cut``)."""
    with trace.span("alaya.captured.replay", graph=key[0],
                    rows=inputs[0].shape[0]) as replay, _lock, \
            torch.cuda.device(dev), eager():       # fn's own runs: as they are
        st = _state(dev)
        entries, pool = (_scopes()[-1].where(dev) if _scopes()
                         else (st.entries, st.pool))
        ent = entries.pop(key, None)
        hit = ent is not None
        if not hit:
            with trace.span("alaya.captured.capture", graph=key[0]):
                ent = make(st, pool)
        replay.set(hit=hit, bucket=ent.static_in[0].shape[0])
        entries[key] = ent                        # most recent last
        while entries is st.entries and len(entries) > MAX_GRAPHS:
            del entries[next(iter(entries))]
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(st.done)
        for buf, x in zip(ent.static_in, inputs):
            if not cut:
                buf.copy_(x)
                continue
            buf[:B].copy_(x)
            if B < buf.shape[0]:
                buf[B:].zero_()
        ent.graph.replay()
        out = tuple((o[:B] if cut else o).clone()
                    for o in ent.static_out)
        st.done.record(stream)
        _add(ent.delta, +1)
        stats["replays"] += 1
        return out


def run(name: str, fn, inputs: Sequence[Tensor], reads=(),
        static=()) -> Tuple[Tensor, ...]:
    """``fn(*inputs)``, replayed from a captured graph on the card (see the
    module's docstring); a tuple of tensors."""
    inputs = tuple(inputs)
    dev = inputs[0].device
    if _uncaptured(dev):
        return tuple(fn(*inputs))
    tensors: list = []
    rkey = _walk(reads, tensors)
    if any(t.device != dev for t in tensors):
        return tuple(fn(*inputs))
    B = inputs[0].shape[0]
    Bp = bucket(B)
    key = (name, tuple(static), Bp,
           tuple((tuple(x.shape[1:]), x.dtype) for x in inputs), rkey,
           torch.backends.cuda.matmul.allow_tf32)

    def make(st, pool):
        static_in = tuple(pad_rows(x, Bp).clone() for x in inputs)
        return _capture(st, pool, fn, static_in,
                        tensors[0] if tensors else None)

    return _replay(dev, key, make, inputs, B)


def chunk_starts(n: int, chunk: int) -> Tuple[list, int]:
    """Chunk starts covering [0, n) with chunks of one size: the tail chunk
    overlaps the one before it (JAX's ``_chunks``)."""
    chunk = min(chunk, n)
    starts = list(range(0, n - chunk + 1, chunk))
    if n % chunk and (not starts or starts[-1] + chunk < n):
        starts.append(n - chunk)
    return starts, chunk


def run_chunks(name: str, fn, n: int, chunk: int, inputs, reads=(),
               static=()) -> Tuple[Tensor, ...]:
    """A build phase's chunk loop: ``fn(rows, *[x[rows] for x in
    inputs])`` for every chunk of [0, n) (``chunk_starts``), where ``rows``
    [C] i32 are the chunk's row ids, an input like the others, so that one
    graph serves every chunk. ``fn`` is row-independent (``run``); its
    outputs are written into [n, ...] tensors, the overlapping tail's rows
    twice with the same values. Each chunk is one ``run``."""
    starts, chunk = chunk_starts(n, chunk)
    dev = inputs[0].device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    outs = None
    for lo in starts:
        got = run(name, fn, (ids[lo:lo + chunk],
                             *(x[lo:lo + chunk] for x in inputs)),
                  reads, static)
        if outs is None:
            outs = tuple(torch.empty((n, *g.shape[1:]), dtype=g.dtype,
                                     device=g.device) for g in got)
        for o, g in zip(outs, got):
            o[lo:lo + chunk] = g
    return outs


def run_inplace(name: str, fn, inputs: Sequence[Tensor],
                idle: Sequence[Tensor], writes=(), reads=(), static=(),
                warm=None) -> Tuple[Tensor, ...]:
    """``fn(*inputs)`` where ``fn`` writes the tensors in ``writes`` in
    place (an insert's connect step: the adjacency and the block space),
    replayed from a captured graph on the card; a tuple of tensors.

    Unlike ``run``, rows are not independent and nothing is padded or
    cut: the caller pads to its bucket, the inputs' shapes are the graph's,
    and every output is cloned whole. The
    key holds the state of ``writes`` as of ``reads`` (pointers, shapes,
    strides, dtypes and every scalar field but ``num``) and every input's
    full shape. ``idle``: inputs of the same shapes under which ``fn``
    changes no state (every row masked); the warm-up before the capture
    runs on them, so the state is written once, by the replay. ``warm``:
    a call that launches every kind of kernel ``fn`` launches and changes
    no state, run in the warm-up's place (where ``fn`` on ``idle`` would
    cost a whole round of the work)."""
    inputs, idle = tuple(inputs), tuple(idle)
    dev = inputs[0].device
    if _uncaptured(dev):
        return tuple(fn(*inputs))
    tensors: list = []
    wkey = _walk(writes, tensors)
    rkey = _walk(reads, tensors)
    key = (name, tuple(static),
           tuple((tuple(x.shape), x.dtype) for x in inputs), wkey, rkey,
           torch.backends.cuda.matmul.allow_tf32)

    def make(st, pool):
        static_in = tuple(x.clone() for x in idle)
        return _capture(st, pool, fn, static_in,
                        tensors[0] if tensors else None, warm)

    return _replay(dev, key, make, inputs, 0, cut=False)
