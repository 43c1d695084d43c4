"""Traffic of the kind ``stretch_fits``: whole ``fit_model`` fits (the
ensemble loop, burn-in, ESS and R-hat) back to back, each from its own
seeded walker starts, until ``--seconds`` have passed. A mix names this
driver by its ``driver`` key and gives ``nwalkers``, ``nsteps``,
``warmup_steps``, ``check_rows`` and the stretch scale ``a``.

The window records, by reference, every lnprob call's rows and values and
each fit's chain and lnp; after the window, :func:`check` holds the lnp of
a seeded sample of post-burn rows to the plain reference, and every
transition of every fit to the stretch move's rule
(``reference/stretch.py``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.harness.calls import CallLog, fit_generator, sync
from portbench.harness.check import value_gaps
from portbench.reference.stretch import judge_fit

# the host's work outside the benchmark's spans: a fit's post-processing
LOOP = "post"


def warm_up(cell, model, seed, device, lnprob=None):
    """One short fit of the cell's shapes, on a generator of its own."""
    if lnprob is not None:
        model._lnprob_batch = lnprob
    cfg = model.cfg
    model.cfg = cfg.replace(nsteps=int(cell.traffic["warmup_steps"]))
    model.fit_model(generator=fit_generator(device, seed, 2 ** 20))
    model.cfg = cfg
    sync(device)


def window(cell, model, seed, seconds, tracer, lnprob=None):
    """Fits back to back until ``seconds`` have passed. With ``--trace
    1`` the first fit times each lnprob call by the host's clock, before
    any profiler has run in the process, and the second fit is the traced
    slice. Returns the window's record."""
    from lumfuncmcmc_tpu_torch.models import ensemble_driver as ed
    device = model.device
    log = CallLog(tracer)
    model._lnprob_batch = log.wrap(lnprob or model.lnprob_batch())
    run_stretch = ed.run_stretch
    lnps = []

    def sampler(*a, **kw):
        with tracer.span("sampler"):
            out = run_stretch(*a, **kw)
        lnps.append(out[2])
        return out

    ed.run_stretch = sampler
    fits = []
    sync(device)
    t0 = time.perf_counter()
    try:
        while True:
            log.timing = tracer.enabled and not fits
            if tracer.enabled and len(fits) == 1:
                tracer.start()
            model.fit_model(generator=fit_generator(device, seed,
                                                    len(fits)))
            tracer.stop()
            rows, vals = log.take()
            nsteps = model.chain.shape[0]
            fits.append({"samples": model.samples, "chain": model.chain,
                         "lnps": lnps.pop().cpu().double().numpy(),
                         "calls": rows, "call_lnp": vals,
                         "evals": model.chain.shape[1] * nsteps,
                         "steps": nsteps})
            if (time.perf_counter() - t0 >= seconds
                    and len(fits) >= (2 if tracer.enabled else 1)):
                break
        sync(device)
        t1 = time.perf_counter()
    finally:
        ed.run_stretch = run_stretch
    return {"t0": t0, "t1": t1, "fits": fits, "log": log,
            "evals": sum(f["evals"] for f in fits), "attempted": len(fits),
            "traced_steps": fits[1]["steps"] if tracer.enabled else None}


def end_to_end(win) -> dict:
    """The cell's end-to-end rates: every fit's walkers x steps over the
    first fit's start to the last fit's end."""
    return {"lnprob_evals_per_s": win["evals"] / (win["t1"] - win["t0"])}


def _transitions(fit, a, device):
    """``judge_fit``'s counts of one fit, from its recorded calls: the
    starts (one call over every walker), then one call a half-step."""
    chain, lnps = fit["chain"], fit["lnps"]
    steps, nw, ndim = chain.shape
    rows, vals = fit["calls"], fit["call_lnp"]
    if rows.shape[0] != nw + steps * nw:
        # the lnprob callable was not called once a half-step: no
        # proposal can be judged
        return {"bad_moves": math.inf, "bad_proposals": math.inf,
                "bad_takes": math.inf, "bad_keeps": math.inf,
                "forced_takes": 0, "forced_keeps": 0}
    nh = nw // 2
    return judge_fit(rows[:nw], vals[:nw], chain, lnps,
                     rows[nw:].reshape(steps, 2, nh, ndim),
                     vals[nw:].reshape(steps, 2, nh), a=a, device=device)


def check(cell, ref, win, seed, device):
    """``(numbers, rows compared)``: ``value_gaps`` of a seeded sample of
    ``check_rows`` post-burn rows of all fits against the reference, and
    the transition counts of every fit, summed."""
    fits, traffic = win["fits"], cell.traffic
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0xC4EC])
    rows = np.concatenate([f["samples"] for f in fits])
    pick = rng.choice(rows.shape[0], size=min(int(traffic["check_rows"]),
                                              rows.shape[0]), replace=False)
    sample = rows[np.sort(pick)]
    with torch.no_grad():
        lnp_ref = ref.lnprob_fn(torch.float64, device)(
            torch.as_tensor(sample[:, :-1], dtype=torch.float64,
                            device=device)).cpu().numpy()
    numbers = value_gaps(sample[:, -1], lnp_ref)
    counts = {}
    for f in fits:
        for k, v in _transitions(f, float(traffic["a"]), device).items():
            counts[k] = counts.get(k, 0) + v
    numbers.update(counts)
    return numbers, len(sample)
