"""The traced slice of a run: ``torch.profiler`` over part of the window,
reduced to device operations, launch calls and the benchmark's own spans
on one timeline (ns)."""

from __future__ import annotations

import time

import numpy as np
import torch

SPAN = "portbench."
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")


class Tracer:
    """Starts and stops the profiler around the traced slice and keeps
    the benchmark's spans. ``active`` is False outside the slice, and
    always without ``--trace 1``."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.active = False
        self.prof = None
        self.t_start = self.t_stop = None
        self.parse_s = None
        self.result = None

    def start(self):
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        from torch.profiler import record_function
        self._window = record_function(SPAN + "window")
        self._window.__enter__()
        self.t_start = time.perf_counter()
        self.active = True

    def stop(self):
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter()
        self.active = False
        self._window.__exit__(None, None, None)
        t0 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.result = reduce(self.prof.profiler.kineto_results.events())
        self.parse_s = time.perf_counter() - t0

    def span(self, name):
        """A benchmark span, recorded while the slice is traced."""
        if self.active:
            from torch.profiler import record_function
            return record_function(SPAN + name)
        return _NULL


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class TraceData:
    """Device operations ``(name, start, end)``, launch call starts, and
    spans by name ``[(start, end)]``, in ns on the profiler's clock."""

    def __init__(self, ops, launches, spans):
        self.ops = ops
        self.launches = np.asarray(sorted(launches), dtype=np.int64)
        self.spans = spans
        # the traced window: from the profiler's start to its stop
        self.window = spans.get("window", [(0, 0)])[0]

    def launches_in(self, name):
        """Launch calls inside the spans ``name``."""
        n = 0
        for s, e in self.spans.get(name, []):
            n += int(np.searchsorted(self.launches, e)
                     - np.searchsorted(self.launches, s))
        return n

    def busy_intervals(self):
        """The union of device-operation intervals inside the window,
        merged, as an (n, 2) array."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(e, w1)) for _, s, e in self.ops
                    if e > w0 and s < w1)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.asarray(merged, dtype=np.int64).reshape(-1, 2)

    def busy_s(self):
        b = self.busy_intervals()
        return float((b[:, 1] - b[:, 0]).sum()) * 1e-9

    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    def idle_gaps(self):
        """Idle stretches of the device inside the window, ``(start,
        end)`` in ns."""
        b = self.busy_intervals()
        w0, w1 = self.window
        edges = np.concatenate([[w0], b.reshape(-1), [w1]]).reshape(-1, 2)
        return [(int(s), int(e)) for s, e in edges if e > s]

    def host_span_at(self, t, loop):
        """The innermost benchmark span the host was in at ``t``:
        ``lnprob`` (a call of the model's lnprob), ``sampler`` (the
        sampler's loop outside it), else ``loop``, the driver's name for
        the rest of its work (``post``: a fit's post-processing)."""
        for name in ("lnprob", "sampler"):
            for s, e in self.spans.get(name, []):
                if s <= t < e:
                    return name
        return loop

    def device_time(self, patterns):
        """Device seconds and instances of the operations whose names
        match any of ``patterns``, inside the window, by pattern."""
        w0, w1 = self.window
        out = [[0.0, 0] for _ in patterns]
        for name, s, e in self.ops:
            if e <= w0 or s >= w1:
                continue
            for i, p in enumerate(patterns):
                if p.search(name):
                    out[i][0] += (e - s) * 1e-9
                    out[i][1] += 1
                    break
        return out


def _ns(e, what):
    """An event's start or duration in ns, across torch versions."""
    fn = getattr(e, what + "_ns", None)
    return int(fn()) if fn else int(getattr(e, what + "_us")() * 1000)


def reduce(events) -> TraceData:
    """The profiler's raw events (``kineto_results.events()``) as a
    :class:`TraceData`. Read raw: building the profiler's event tree costs
    ~1 ms an event, minutes for one traced fit."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches, spans = [], [], {}
    for e in events:
        name = e.name()
        if name.startswith(SPAN):
            if e.device_type() != cuda:
                s = _ns(e, "start")
                spans.setdefault(name[len(SPAN):], []).append(
                    (s, s + _ns(e, "duration")))
        elif e.device_type() == cuda:
            s = _ns(e, "start")
            ops.append((name, s, s + _ns(e, "duration")))
        elif name.startswith(LAUNCH_PREFIXES):
            launches.append(_ns(e, "start"))
    return TraceData(ops, launches, spans)


def breakdown(trace: TraceData, loop: str, top=10):
    """The device operations that took most time, and the device's idle
    time by the benchmark span the host was in, each at most ``top``
    entries of ``[name, seconds]``."""
    by_op = {}
    w0, w1 = trace.window
    for name, s, e in trace.ops:
        if e > w0 and s < w1:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0.0) + (min(e, w1) - max(s, w0)) * 1e-9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = {}
    for s, e in trace.idle_gaps():
        k = trace.host_span_at(s, loop)
        idle[k] = idle.get(k, 0.0) + (e - s) * 1e-9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def short_name(name: str) -> str:
    """'void free_vg<1, 1>(float const*, ...)' -> 'free_vg<1, 1>'."""
    head = name.split("(")[0]
    return head[5:] if head.startswith("void ") else head
