"""build.fit_s (s): the fit's phases as ``IndexEngine.build_timings``
gives them (each closed by a device sync), summed."""


def read(run):
    t = run.build_timings
    if not t:
        return None
    return float(sum(t.values()))
