"""setup_s (s): process start to the first timed operation (imports,
kernels built or loaded, data, fit, warm-up)."""


def read(run):
    return run.setup_s
