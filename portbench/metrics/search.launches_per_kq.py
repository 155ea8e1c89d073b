"""search.launches_per_kq (launches/kq): the change in the port's kernel
``.launches`` counters over the window (replays counted as their
captures launched) per 1,000 queries answered."""


def read(run):
    w = run.window
    if not w.get("answered") or "calls" not in w:
        return None
    return (run.after["launches"] - run.before["launches"]) / (
        w["answered"] / 1000.0)
