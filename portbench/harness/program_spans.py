"""The program's own stage spans in the traced slice: the ``lf.*`` events
that ``lumfuncmcmc_tpu_torch.utils.tracing.span`` opens while a profiler
records, read from the slice's raw profiler events on the clock of
``trace.py``'s ``TraceData`` (ns), and the arithmetic the span metrics
share. A program without such spans gives none, and each metric reading
them then returns None."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.trace import _ns

PROGRAM = "lf."


def reduce_program(events) -> dict:
    """``{name: [(start, end)]}``, sorted, of the host-side events whose
    names start with ``lf.``, under their full names."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = {}
    for e in events:
        name = e.name()
        if name.startswith(PROGRAM) and e.device_type() != cuda:
            s = _ns(e, "start")
            spans.setdefault(name, []).append((s, s + _ns(e, "duration")))
    return {k: sorted(v) for k, v in spans.items()}


def program_spans(run) -> dict:
    """The program's spans of ``run``'s traced slice that lie inside its
    window, read once a run from the profiler the benchmark's tracer ran
    (``run.log.tracer``); ``{}`` without a traced slice."""
    got = getattr(run, "program_spans", None)
    if got is None:
        prof = getattr(getattr(run.log, "tracer", None), "prof", None)
        got = {}
        if run.trace is not None and prof is not None:
            w0, w1 = run.trace.window
            for name, iv in reduce_program(
                    prof.profiler.kineto_results.events()).items():
                iv = [(s, e) for s, e in iv if s >= w0 and e <= w1]
                if iv:
                    got[name] = iv
        run.program_spans = got
    return got


def mean_us(run, name: str):
    """The mean duration of the spans ``lf.<name>``, in us."""
    iv = program_spans(run).get(PROGRAM + name)
    if not iv:
        return None
    return 1e-3 * sum(e - s for s, e in iv) / len(iv)


def total_s(run, name: str):
    """The summed duration of the spans ``lf.<name>``, in s."""
    iv = program_spans(run).get(PROGRAM + name)
    return 1e-9 * sum(e - s for s, e in iv) if iv else None


def self_us(run, name: str, child: str):
    """The mean, over the spans ``lf.<name>``, of each one's duration
    less the durations of the spans ``lf.<child>`` that start inside it,
    in us."""
    spans = program_spans(run)
    iv = spans.get(PROGRAM + name)
    if not iv:
        return None
    kids = np.asarray(spans.get(PROGRAM + child, []),
                      dtype=np.int64).reshape(-1, 2)
    starts = kids[:, 0]
    # cumulative child durations, so each parent's sum is one difference
    cum = np.concatenate([[0], np.cumsum(kids[:, 1] - kids[:, 0])])
    total = 0
    for s, e in iv:
        i, j = np.searchsorted(starts, s), np.searchsorted(starts, e)
        total += (e - s) - int(cum[j] - cum[i])
    return 1e-3 * total / len(iv)
