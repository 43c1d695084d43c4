"""Arithmetic shared by the per-layer metrics' readers. Each reader
returns None where its run has nothing to read, and the metric is then
left out of the result line."""

from __future__ import annotations


def roofline_pct(run, wrapper: str):
    """The share of its roofline that the program's kernel ``wrapper``
    reached over the traced slice: the mean least time of one call (the
    larger of its operations over the float32 peak and its bytes over the
    HBM peak, from ``portbench/counts`` and the calls' rows) over the
    mean device time of one call, in %."""
    trace = run.trace
    rows = run.log.traced_rows
    if trace is None or not rows:
        return None
    family, pats = run.cell.kernel_names(wrapper)
    found = trace.device_time(pats)
    calls = found[0][1] if found else 0
    device_s = sum(s for s, _ in found)
    if not calls or device_s <= 0.0:
        return None
    counts = run.cell.counts(family)
    peaks = run.cell.peaks()
    bound = 0.0
    for w in rows:
        ops, nbytes = counts(wrapper, w, run.shapes["cells"],
                             run.shapes["sources"], run.shapes["fields"])
        bound += max(ops / peaks["float32_ops_per_s"],
                     nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * (bound / len(rows)) / (device_s / calls)


def idle_pct(run):
    """The device's idle share of the traced slice, in %."""
    trace = run.trace
    if trace is None or trace.window_s() <= 0.0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())
