"""Device lists for the sharded paths (port of ``utils/platforms.py``).

The JAX package validates sharding on N virtual CPU devices
(``force_cpu_devices``, ``--xla_force_host_platform_device_count``). The
port's counterpart is ``force_devices(n, device)``: from then on
``devices(kind)`` returns ``n`` copies of ``device`` for the whole process,
so a mesh can place several shards on one device (virtual shards). Each
shard still holds only its own rows; only the device they sit on repeats.
``force_devices`` returns a handle whose ``restore()`` (or the end of its
``with`` block) puts back the list that was in force before.

Without a forced list ``devices(kind)`` returns the real devices:
``torch.cuda.device_count()`` CUDA devices, or the one CPU.

``cpu_env`` and ``enable_compile_cache`` have no counterpart: they set
XLA's flags and XLA's compilation cache, which PyTorch does not have.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

_FORCED: Optional[List[torch.device]] = None


def devices(kind: Optional[str] = None) -> List[torch.device]:
    """The devices a mesh of ``kind`` ("cuda", "cpu" or None for the
    default: CUDA where present) can use: the forced list where one is in
    force for that kind, else the real devices."""
    if _FORCED is not None and kind in (None, _FORCED[0].type):
        return list(_FORCED)
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cuda":
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device kind {kind!r}")


class force_devices:
    """Make ``devices()`` return ``n`` copies of ``device`` until
    ``restore()`` or the end of a ``with`` block."""

    def __init__(self, n: int, device: Union[str, torch.device] = "cpu"):
        global _FORCED
        if n < 1:
            raise ValueError(f"force_devices needs n >= 1, got {n}")
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        self._previous = _FORCED
        self._restored = False
        _FORCED = [dev] * int(n)

    def restore(self) -> None:
        global _FORCED
        if not self._restored:
            _FORCED = self._previous
            self._restored = True

    def __enter__(self) -> "force_devices":
        return self

    def __exit__(self, *exc) -> None:
        self.restore()
