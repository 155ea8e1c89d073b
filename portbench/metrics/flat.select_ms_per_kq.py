"""flat.select_ms_per_kq (ms/kq): the traced device seconds of the flat
scan's selection per 1,000 queries answered: every device operation in the
traced span except two, which it subtracts by name:

  ``l2_tile_kernel``   the distance tile (``l2_tile_roofline.L2_TILE``,
                       whose reader reads it);
  ``Memcpy HtoD`` / ``Memcpy DtoH``   the copies between host and card
                       (the queries in, the answers and the masked tiles'
                       flags out).

What is left is the selection: ``torch.topk``, the sorts and gathers, the
fills, ``merge_kv`` and the answers' join, and whatever kernel later takes
them over. It is read only where the trace holds every ``l2_tile`` launch
of the calls it spans (the window's launches a call, a whole number, times
the calls traced): otherwise the span cut a call or the window scanned
nothing, and nothing is read."""

import re

from portbench.metrics.l2_tile_roofline import L2_TILE

COPY = re.compile(r"^Memcpy (HtoD|DtoH)")


def read(run):
    tr, w = run.trace_result, run.window
    if tr is None or not tr.work.get("queries") or not w.get("calls"):
        return None
    launched = (run.after["by_kernel"].get("l2_tile", 0)
                - run.before["by_kernel"].get("l2_tile", 0))
    per_call, rest = divmod(launched, w["calls"])
    _, n = tr.device_seconds(lambda name: bool(L2_TILE.search(name)))
    if not per_call or rest or n != per_call * tr.work["calls"]:
        return None
    sec, _ = tr.device_seconds(lambda name: not (L2_TILE.search(name)
                                                 or COPY.search(name)))
    return sec * 1e3 / (tr.work["queries"] / 1000.0)
