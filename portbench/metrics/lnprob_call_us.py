"""Host wall time of one call of the model's lnprob (a span around the
callable, no device sync), mean over the calls of the first fit of a
``--trace 1`` run, which runs before any profiler has in the process
(the traced slice is the second fit), in us."""


def read(run):
    host = run.log.host_s
    return 1e6 * sum(host) / len(host) if host else None
