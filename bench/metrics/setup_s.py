"""setup_s: process start to the window's start (weights drawn, engine or
optimizer built, kernels loaded or built, warm-up, a batch filled)."""
NAME, UNIT, SOURCE = "setup_s", "s", "host_clock"


def read(run):
    return run["setup_s"]
