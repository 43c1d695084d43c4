"""Host time of the program's feature map in one lnprob call: the mean
duration of its ``lf.features`` spans (clamp, feature map,
straight-through rounding) over the traced fit, in us."""

from portbench.harness.program_spans import mean_us


def read(run):
    return mean_us(run, "features")
