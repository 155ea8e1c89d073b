"""kernel.gather_estimate.ms_per_kq (ms/kq): the profiler's summed
device ms of ``gather_estimate`` (``gather_rows_kernel<.., true>``, the
estimate fused in) in the traced span, per 1,000 queries it answered."""

from portbench.metrics._common import GATHER_ESTIMATE


def read(run):
    tr = run.trace_result
    if tr is None or not tr.work.get("queries"):
        return None
    sec, n = tr.device_seconds(lambda name: bool(GATHER_ESTIMATE.search(name)))
    if n == 0:
        return None
    return sec * 1e3 / (tr.work["queries"] / 1000.0)
