"""Seconds of the model's construction (catalog to context, the grid and
the per-source arrays, on the run's device), by the benchmark's clock
with a device sync."""


def read(run):
    return run.counters.get("context_build_s")
