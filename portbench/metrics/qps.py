"""qps (queries/s): queries answered in the closed loop's window over the
window's seconds, every call whole."""


from portbench import stats


def read(run):
    w = run.window
    if "calls" not in w:
        return None
    return stats.rate(w["answered"], w["seconds"])
