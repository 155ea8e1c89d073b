"""Entry-point selection (port of ``index/nsg.py::find_medoid``).

The NSG builder itself, with the host connectivity repair
(``nsg._attach_unreached``), waits in ROADMAP queue 1, item 8.
"""

from __future__ import annotations

from ..ops.distance import exact_topk


def find_medoid(space, n: int) -> int:
    """Entry point = node nearest the dataset centroid."""
    data = space.data[:n].float()
    mean = data.mean(0, keepdim=True)
    _, ids = exact_topk(mean, data, 1, metric=space.metric)
    return int(ids[0, 0])
