"""device.idle_share.* (%): 1 − the union of the device's operation
intervals over the traced span's wall, from torch.profiler."""

from portbench.metrics._common import idle_share as read  # noqa: F401
