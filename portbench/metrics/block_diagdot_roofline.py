"""block_diagdot_roofline (%): the least time the traced span's
``block_diagdot`` launches (the RaBitQ hop's dot over the unpacked codes)
could take on the card, over the profiler's summed time of those launches.
The least time is their bytes over HBM's peak (``roofline.bound_s``): the
u8 codes [B, K, Dp] and the bf16 query [B, Dp] read once, the f32 dots
[B, K] written once.

The launches' shapes: after the window, one search of the same batch runs
uncaptured with the benchmark's own wrapper around the RaBitQ space's
``block_diagdot`` (the replays launch what the uncaptured calls launch);
the count it records has to equal the window's change in
``block_diagdot.launches`` per call. The bytes of the launches the trace
holds are its count times the call's mean bytes a launch (as
``pool_merge_roofline`` counts them). More launches traced than the calls
made is a fault: nothing is read.

The kernel's name on the trace: ``block_diagdot`` is the rows kernel of
``csrc/gather_diagdot.cu`` without the fused estimate,
``gather_rows_kernel<N, false>``. ``gather_estimate`` launches the same
template with ``true``, which the pattern leaves out; ``gather_diagdot``'s
rows entry launches it with ``false`` too, so nothing is read where the
window launched ``gather_diagdot``."""

import re

from portbench import roofline

BLOCK_DIAGDOT = re.compile(r"gather_rows_kernel<\s*\d+\s*,\s*false\s*>")


def block_diagdot_bytes(B: int, K: int, Dp: int) -> int:
    """One launch over codes [B, K, Dp] u8 and qs [B, Dp] bf16 into f32
    dots [B, K]: every input byte read once, the output written once."""
    return B * K * Dp + B * Dp * 2 + B * K * 4


def probe(run):
    if run.trace_result is None or "calls" not in run.window:
        return
    import torch
    from alayalite_tpu_torch.ops.diagdot import block_diagdot
    from alayalite_tpu_torch.spaces import rabitq

    loop = run.loop
    shapes = []
    orig = rabitq.block_diagdot

    def recorded(codes, qs):
        shapes.append(tuple(codes.shape))
        return orig(codes, qs)

    before = block_diagdot.launches
    rabitq.block_diagdot = recorded
    try:
        run.idx._engine._batch_search_impl(loop.data.queries, loop.k,
                                           loop.ef, _capture=False)
        torch.cuda.synchronize(run.device)
    except TypeError:
        return
    finally:
        rabitq.block_diagdot = orig
    launched = block_diagdot.launches - before
    run.info["block_diagdot_probe"] = {"launched": launched,
                                       "recorded": len(shapes)}
    if launched == len(shapes):
        run.probes["block_diagdot"] = shapes


def read(run):
    tr, shapes = run.trace_result, run.probes.get("block_diagdot")
    if tr is None or not shapes:
        return None

    def in_window(name):
        return (run.after["by_kernel"].get(name, 0)
                - run.before["by_kernel"].get(name, 0))

    per_call = in_window("block_diagdot") / run.window["calls"]
    sec, n = tr.device_seconds(lambda name: bool(BLOCK_DIAGDOT.search(name)))
    expected = tr.work["calls"] * len(shapes)
    run.info["block_diagdot_traced"] = {"launches": n, "expected": expected,
                                        "per_call": per_call}
    if (per_call != len(shapes) or in_window("gather_diagdot") or n == 0
            or n > expected or sec <= 0):
        return None
    per_launch = sum(block_diagdot_bytes(*s) for s in shapes) / len(shapes)
    return 100.0 * roofline.bound_s(per_launch * n) / sec
