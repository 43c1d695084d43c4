"""Kernel-launch calls (``cudaLaunch*`` in the trace) inside the traced
fit's stretch loop (the ``sampler`` span around ``run_stretch``), per
step."""


def read(run):
    trace, steps = run.trace, run.window.get("traced_steps")
    if trace is None or not steps:
        return None
    n = trace.launches_in("sampler")
    return n / steps if n else None
