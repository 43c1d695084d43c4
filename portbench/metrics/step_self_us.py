"""The ensemble loop's own host time a step: the mean, over the traced
fit's ``lf.step`` spans, of each step's duration less its ``lf.lnprob``
spans (proposals, accept decisions, bookkeeping, and the benchmark's
thin wrapper around the lnprob callable), in us."""

from portbench.harness.program_spans import self_us


def read(run):
    return self_us(run, "step", "lnprob")
