"""rabitq.exact_rows_per_q (rows/q): the float32 rows that the RaBitQ
space's ``gather_dists`` read (the program's counter
``spaces/rabitq.counters.exact_rows``: the seeds, each hop's popped nodes
for the result pool, the final re-score of the boosted pool, on every
padded row) per query answered.

The run reads only the kernels' launches around the window, so the count
is taken around one more call of the cell's own search after the window
(the same queries, shapes and captured graphs as every call of the
window's) and counted once for each of the window's calls. That call is
held to the window by the RaBitQ hop's kernel: its ``block_diagdot``
launches must equal the window's change in ``block_diagdot.launches`` per
call. Where they differ, or the program has no such counter, nothing is
read."""


def probe(run):
    w = run.window
    call = getattr(run.loop, "call", None)
    if not w.get("calls") or call is None:
        return
    try:
        from alayalite_tpu_torch.ops.diagdot import block_diagdot
        from alayalite_tpu_torch.spaces.rabitq import counters
    except ImportError:
        return
    import torch

    rows, launches = counters.exact_rows, block_diagdot.launches
    call()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.probes["rabitq.exact_rows"] = {
        "exact_rows": counters.exact_rows - rows,
        "block_diagdot": block_diagdot.launches - launches}


def read(run):
    p, w = run.probes.get("rabitq.exact_rows"), run.window
    if not p or not p["exact_rows"] or not w.get("answered"):
        return None
    per_call = (run.after["by_kernel"].get("block_diagdot", 0)
                - run.before["by_kernel"].get("block_diagdot", 0)) / w["calls"]
    run.info["rabitq_exact_rows_probe"] = dict(
        p, window_block_diagdot_per_call=per_call)
    if per_call != p["block_diagdot"]:
        return None
    return p["exact_rows"] * w["calls"] / w["answered"]
