"""``fit_model``'s post-processing in the traced fit: the duration of
its ``lf.post`` span (the chain's copies to the host, burn-in, ESS,
R-hat, the convergence log, the samples table), in s."""

from portbench.harness.program_spans import total_s


def read(run):
    return total_s(run, "post")
