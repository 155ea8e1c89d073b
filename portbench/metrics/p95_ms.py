"""p95_ms (ms): 95th percentile over every request due in the open
loop's window, from its due time to its result; a request that failed or
never came sorts past every other (no finite value then)."""

from portbench import stats
from portbench.metrics._common import finite


def read(run):
    lat = run.window.get("latency_s")
    if lat is None:
        return None
    return finite(stats.percentile(lat, 95) * 1e3)
