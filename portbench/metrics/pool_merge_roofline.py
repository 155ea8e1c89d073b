"""pool_merge_roofline (%): the least time the traced span's
``pool_merge`` launches could take on the card (their bytes: both
operands' keys, ids and flags read once, the pool written once, over
HBM's peak) over the profiler's summed time of those launches.

The launches' shapes: after the window, one search of the same batch
runs uncaptured with the benchmark's own wrapper around ``pool_merge``
(the replays launch what the uncaptured calls launch); the count it
records has to equal the window's change in ``pool_merge.launches`` per
call. The bytes of the launches the trace holds are its count times the
call's mean bytes a launch: the tracer may drop a few of a span's ~10^5
device records, and a count checked for equality would then read
nothing. More launches traced than the calls made is a fault: nothing is
read."""

from portbench import roofline
from portbench.metrics._common import POOL_MERGE


def probe(run):
    if run.trace_result is None or "calls" not in run.window:
        return
    import torch
    from alayalite_tpu_torch.ops import pool_sort, topk

    loop = run.loop
    shapes = []
    orig = topk.pool_merge

    def spanned(d1, i1, f1, d2, i2, f2, k, dedup=False):
        out = orig(d1, i1, f1, d2, i2, f2, k, dedup)
        if d1.shape[0] and out[0].shape[1]:
            shapes.append((d1.shape[0], d1.shape[1], d2.shape[1],
                           out[0].shape[1], f1 is not None))
        return out

    before = pool_sort.pool_merge.launches
    topk.pool_merge = spanned
    try:
        run.idx._engine._batch_search_impl(loop.data.queries, loop.k,
                                           loop.ef, _capture=False)
        torch.cuda.synchronize(run.device)
    except TypeError:
        return
    finally:
        topk.pool_merge = orig
    launched = pool_sort.pool_merge.launches - before
    run.info["pool_merge_probe"] = {"launched": launched,
                                    "recorded": len(shapes)}
    if launched == len(shapes):
        run.probes["pool_merge"] = shapes


def read(run):
    tr, shapes = run.trace_result, run.probes.get("pool_merge")
    if tr is None or not shapes:
        return None
    per_call = (run.after["by_kernel"]["pool_merge"]
                - run.before["by_kernel"]["pool_merge"]) / run.window["calls"]
    sec, n = tr.device_seconds(lambda name: bool(POOL_MERGE.search(name)))
    expected = tr.work["calls"] * len(shapes)
    run.info["pool_merge_traced"] = {"launches": n, "expected": expected,
                                     "per_call": per_call}
    if per_call != len(shapes) or n == 0 or n > expected or sec <= 0:
        return None
    per_launch = sum(roofline.pool_merge_bytes(*s) for s in shapes) / len(shapes)
    return 100.0 * roofline.bound_s(per_launch * n) / sec
