"""gather_estimate_roofline (%): the least time the traced span's
``gather_estimate`` launches (the bsq8 hop: each popped node's code block
gathered by id, the dot and the estimate's epilogue fused) could take on
the card, over the profiler's summed time of those launches. The least
time is their bytes over HBM's peak (``roofline.bound_s``), each distinct
node's block counted once however many (query, pop) pairs address it:

  codes         R·Dp u8 a distinct node
  xsq, ids      R·(4 + 4) (f32 norms, i32 neighbour ids) a distinct node
  qs, qconst    B·(2·Dp + 4) (bf16 query, f32 constant)
  u             B·M·4 (i32 popped ids)
  est, ids out  B·M·R·(4 + 4) (the kernel writes both)

The bytes are a floor on what must move, so the share cannot pass 100%.

The launches' shapes: after the window, one search of the same batch runs
uncaptured with the benchmark's own wrapper around the BQG space's
``gather_estimate`` (the replays launch what the uncaptured calls launch);
for each launch it records (B, M, R, Dp) and the distinct ids >= 0 of its
``u`` (``torch.unique`` on the card, outside the window). The count it
records has to equal the launches it made and the window's change in
``gather_estimate.launches`` per call. The bytes of the launches the trace
holds are its count times the call's mean bytes a launch (as
``pool_merge_roofline`` counts them). More launches traced than the calls
made is a fault: nothing is read.

The probe also records that call's change in the program's counter
``gather_estimate.code_bytes`` (None where the program has no such
counter), which ``search.code_kb_per_q`` reads."""

from portbench import roofline
from portbench.metrics._common import GATHER_ESTIMATE


def gather_estimate_bytes(B: int, M: int, R: int, Dp: int,
                          distinct: int) -> int:
    """One launch over ``distinct`` popped nodes' blocks [R, Dp] u8 with
    their norms and ids, B queries' bf16 qs and f32 qconst, the [B, M]
    popped ids, into [B, M·R] f32 estimates and i32 ids."""
    return (distinct * R * (Dp + 8) + B * (2 * Dp + 4) + B * M * 4
            + B * M * R * 8)


def probe(run):
    if run.trace_result is None or not run.window.get("calls"):
        return
    import torch
    from alayalite_tpu_torch.ops.gather_diagdot import gather_estimate
    from alayalite_tpu_torch.spaces import bqg

    loop = run.loop
    shapes = []
    orig = bqg.gather_estimate

    def recorded(codes, u, *args, **kwargs):
        B, M = u.shape
        _, R, Dp = codes.shape
        distinct = int(torch.unique(u[u >= 0]).numel())
        shapes.append((B, M, R, Dp, distinct))
        return orig(codes, u, *args, **kwargs)

    launches = gather_estimate.launches
    code_bytes = getattr(gather_estimate, "code_bytes", None)
    bqg.gather_estimate = recorded
    try:
        run.idx._engine._batch_search_impl(loop.data.queries, loop.k,
                                           loop.ef, _capture=False)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    except TypeError:
        return
    finally:
        bqg.gather_estimate = orig
    if code_bytes is not None:
        code_bytes = gather_estimate.code_bytes - code_bytes
    run.probes["gather_estimate"] = {
        "shapes": shapes, "launched": gather_estimate.launches - launches,
        "code_bytes": code_bytes}


def read(run):
    tr, p = run.trace_result, run.probes.get("gather_estimate")
    if tr is None or not p or not p["shapes"]:
        return None
    shapes = p["shapes"]
    per_call = (run.after["by_kernel"].get("gather_estimate", 0)
                - run.before["by_kernel"].get("gather_estimate", 0)
                ) / run.window["calls"]
    sec, n = tr.device_seconds(lambda name: bool(GATHER_ESTIMATE.search(name)))
    expected = tr.work["calls"] * len(shapes)
    run.info["gather_estimate_traced"] = {
        "launches": n, "expected": expected, "per_call": per_call,
        "probe_launched": p["launched"],
        "distinct_per_launch": sum(s[4] for s in shapes) / len(shapes)}
    if (p["launched"] != len(shapes) or per_call != len(shapes) or n == 0
            or n > expected or sec <= 0):
        return None
    per_launch = sum(gather_estimate_bytes(*s) for s in shapes) / len(shapes)
    return 100.0 * roofline.bound_s(per_launch * n) / sec
