"""Host time of the collapsed source terms in one lnprob call: the mean
duration of its ``lf.collapse`` spans (the float64 theta-affine source
sums of the streaming route, added to the kernel's value) over the traced
fit, in us. A program without the span gives none."""

from portbench.harness.program_spans import mean_us


def read(run):
    return mean_us(run, "collapse")
