#!/usr/bin/env python3
"""The JAX package's reading beside ``scripts/torch_rabitq_recall.py``: the
same 1-bit rabitq config, rows, queries, hop budget and insert, through
``alayalite_tpu``.

    JAX_PLATFORMS=cpu python3 scripts/rabitq_recall_jax.py --n 100000
        [--nq 1000] [--ef 48 64 96] [--insert 1000] [--save DIR]
        [--load DIR] [--stats] [--out FILE.json]

``--device`` and ``--threads`` are accepted and ignored.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    import torch_rabitq_recall as common
    from alayalite_tpu import Index, IndexParams
    from alayalite_tpu.utils.datasets import random_dataset
    from alayalite_tpu.utils.evaluate import calc_recall

    common.run(common.parse_args(), "jax", Index, IndexParams,
               random_dataset, calc_recall, {})
    return 0


if __name__ == "__main__":
    sys.exit(main())
