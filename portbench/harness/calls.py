"""What every window driver shares: device syncs, the seeded generators
of the fits, and the benchmark's counters and spans around the model's
lnprob callable (the program itself is not changed)."""

from __future__ import annotations

import time

import numpy as np
import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_generator(device, seed: int, index: int) -> torch.Generator:
    """The generator of fit ``index`` of a run with ``seed``: the same
    seed gives every fit the same walker starts and draws."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), 0x5EED, index]).generate_state(
            1, np.uint64)[0] >> np.uint64(1)))
    return g


class CallLog:
    """Counters and spans around the model's lnprob callable: calls; the
    rows of each call made while the slice is traced; with ``timing`` on,
    the host's wall time of each call; and each call's rows and values
    (references only: no copy, no device work), which :meth:`take` hands
    over."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.timing = False
        self.calls = 0
        self.traced_rows = []
        self.host_s = []
        self._kept = []

    def wrap(self, fn):
        """``fn`` with the lnprob span, the clock and the record."""
        tracer = self.tracer

        def call(theta):
            self.calls += 1
            if tracer.active:
                self.traced_rows.append(int(theta.shape[0]))
                with tracer.span("lnprob"):
                    out = fn(theta)
            elif self.timing:
                t0 = time.perf_counter()
                out = fn(theta)
                self.host_s.append(time.perf_counter() - t0)
            else:
                out = fn(theta)
            self._kept.append((theta, out))
            return out

        for k in ("data", "engine", "stream"):
            if hasattr(fn, k):
                setattr(call, k, getattr(fn, k))
        return call

    def take(self):
        """The recorded calls since the last ``take``: ``(rows (N, D),
        values (N,))`` as float64 host arrays, or None."""
        kept, self._kept = self._kept, []
        if not kept:
            return None
        rows = torch.cat([t.reshape(-1, t.shape[-1]) for t, _ in kept])
        vals = torch.cat([o.reshape(-1) for _, o in kept])
        return (rows.cpu().double().numpy(), vals.cpu().double().numpy())
