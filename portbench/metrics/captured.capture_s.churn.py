"""captured.capture_s.* (s): seconds the captured layer spent capturing
CUDA graphs inside the window; 0 where the warm-up covered every key."""

from portbench.metrics._common import capture_s as read  # noqa: F401
