"""serving.mean_batch (queries/batch): the queries the SearchServer's
dispatcher popped in the window over its batches (its own counters)."""


def read(run):
    s = run.window.get("server")
    if not s or s["batches"] <= 0:
        return None
    return s["queries"] / s["batches"]
