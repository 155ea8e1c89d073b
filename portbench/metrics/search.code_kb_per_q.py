"""search.code_kb_per_q (KiB/q): the code bytes the block search's
``gather_estimate`` calls address (the program's counter
``gather_estimate.code_bytes``: Σ B·M·R·Dp, every (query, popped node)
pair's block once, the slice's padded rows and each code row's pad bytes
included) per query answered, in KiB.

The run reads only the kernels' launches around the window, so the count
is the counter's change over the one search after the window that
``gather_estimate_roofline``'s probe runs (the same queries, ef and
shapes as every call of the window's), counted once for each of the
window's calls. That call is held to the window by ``gather_estimate``'s
launches: they must equal the window's change in
``gather_estimate.launches`` per call. Where they differ, the probe did not
run, or the program has no such counter, nothing is read."""


def read(run):
    p, w = run.probes.get("gather_estimate"), run.window
    if not p or not p["code_bytes"] or not w.get("answered"):
        return None
    per_call = (run.after["by_kernel"].get("gather_estimate", 0)
                - run.before["by_kernel"].get("gather_estimate", 0)
                ) / w["calls"]
    if per_call != p["launched"]:
        return None
    return p["code_bytes"] * w["calls"] / w["answered"] / 1024.0
