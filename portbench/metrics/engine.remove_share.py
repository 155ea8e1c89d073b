"""engine.remove_share (%): the benchmark's own span around each
``Index.remove`` (its auto-compaction included) over the window."""


def read(run):
    w = run.window
    if "remove_s" not in w:
        return None
    return 100.0 * w["remove_s"] / w["seconds"]
