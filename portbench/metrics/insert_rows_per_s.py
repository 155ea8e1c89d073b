"""insert_rows_per_s (rows/s): rows inserted in the ingest window over
its seconds; the removes and the compactions they trigger run inside."""


from portbench import stats


def read(run):
    w = run.window
    if "rows_inserted" not in w:
        return None
    return stats.rate(w["rows_inserted"], w["seconds"])
