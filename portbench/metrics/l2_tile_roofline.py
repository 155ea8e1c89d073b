"""l2_tile_roofline (%): the least time the traced span's ``l2_tile``
launches (the flat index's exact scan: a [Q, N] squared-L2 tile in f32 on
the CUDA cores) could take on the card, over the profiler's summed time of
those launches.

The least time of a launch is the larger of its operations at the f32
peak and its bytes at HBM's peak (``roofline.bound_s``): 2·Q·N·D
operations (a multiply and an add a pair and dimension; the norms and the
epilogue, O(Q·N + (Q + N)·D), left out), both operands read once and the
f32 tile written once.

The launches' shapes: after the window, one search of the same batch runs
uncaptured with the benchmark's own wrapper around the scan's ``l2_tile``
(``ops/distance``'s name for it). The operations come from the program's
counter ``ops/distance.counters.pairs`` read around that call, which has
to equal Σ Q·N of the shapes recorded, and the call's ``l2_tile``
launches have to equal the window's change in ``l2_tile.launches`` per
call. The bound of the launches the trace holds is their count times the
call's mean bound a launch. More launches traced than the calls made is a
fault: nothing is read. A program without the counter reads nothing.

The kernel's name on the trace: ``l2_tile_kernel<true|false>`` of
``csrc/l2_tile.cu`` (the template flag picks vector loads)."""

import re

from portbench import roofline

L2_TILE = re.compile(r"l2_tile_kernel")


def l2_tile_ops(Q: int, N: int, D: int) -> int:
    """One launch over q [Q, D] and x [N, D]: a multiply and an add for
    each (query, row, dimension)."""
    return 2 * Q * N * D


def l2_tile_bytes(Q: int, N: int, D: int) -> int:
    """One launch: q [Q, D] and x [N, D] f32 read once, the f32 tile
    [Q, N] written once."""
    return 4 * (Q * D + N * D + Q * N)


def probe(run):
    if run.trace_result is None or not run.window.get("calls"):
        return
    try:
        from alayalite_tpu_torch.ops import distance
        from alayalite_tpu_torch.ops.distance import counters
        from alayalite_tpu_torch.ops.l2_tile import l2_tile
    except ImportError:
        return
    import torch

    loop = run.loop
    shapes = []
    orig = distance.l2_tile

    def recorded(q, x):
        shapes.append((q.shape[0], x.shape[0], q.shape[1]))
        return orig(q, x)

    pairs, launches = counters.pairs, l2_tile.launches
    distance.l2_tile = recorded
    try:
        run.idx._engine._batch_search_impl(loop.data.queries, loop.k,
                                           loop.ef, _capture=False)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    except TypeError:
        return
    finally:
        distance.l2_tile = orig
    run.probes["l2_tile"] = {"shapes": shapes,
                             "pairs": counters.pairs - pairs,
                             "launched": l2_tile.launches - launches}


def read(run):
    tr, p = run.trace_result, run.probes.get("l2_tile")
    if tr is None or not p or not p["shapes"]:
        return None
    shapes = p["shapes"]
    per_call = (run.after["by_kernel"].get("l2_tile", 0)
                - run.before["by_kernel"].get("l2_tile", 0)) / run.window["calls"]
    sec, n = tr.device_seconds(lambda name: bool(L2_TILE.search(name)))
    expected = tr.work["calls"] * len(shapes)
    run.info["l2_tile_traced"] = {"launches": n, "expected": expected,
                                  "per_call": per_call,
                                  "probe_launched": p["launched"],
                                  "probe_pairs": p["pairs"]}
    if (p["launched"] != len(shapes) or per_call != len(shapes)
            or p["pairs"] != sum(q * m for q, m, _ in shapes)
            or n == 0 or n > expected or sec <= 0):
        return None
    per_launch = sum(roofline.bound_s(l2_tile_bytes(*s), l2_tile_ops(*s))
                     for s in shapes) / len(shapes)
    return 100.0 * per_launch * n / sec
