"""Host time of one value-kernel call as the program makes it: the mean
duration of its ``lf.kernel`` spans (the wrapper's checks, launch
geometry, scratch allocation and the launch itself) over the traced fit,
in us."""

from portbench.harness.program_spans import mean_us


def read(run):
    return mean_us(run, "kernel")
