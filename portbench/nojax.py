"""The check that nothing a run loaded is JAX or the JAX package.

Top-level module names (the part before the first dot) are compared
whole, so ``alayalite_tpu_torch`` is not ``alayalite_tpu``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "alayalite_tpu"})


def found(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``
    by default), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
