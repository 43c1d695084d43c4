"""Gradient-based No-U-Turn sampling (port of
``lumfuncmcmc_tpu/samplers/nuts.py``).

- Box priors are removed by a logit reparameterization
  (:func:`make_unconstrained`), with the log-Jacobian added.
- :func:`_nuts_step` is one multinomial NUTS transition for C chains at
  once: trajectories double until a U-turn, a divergence or
  ``max_doublings``, with U-turn checks at every dyadic sub-subtree
  boundary (the iterative checkpoint scheme). Where the JAX package
  ``vmap``s a transition made of two nested ``lax.while_loop``s, this
  runs the same two loops over the whole batch with a done-mask per
  lane: a finished lane's state is frozen, and a loop ends when no lane
  is running. That test reads one boolean from the device per leapfrog
  step (a host sync; JAX's batched ``while_loop`` makes the same test on
  the device), counted in :class:`NutsCounts`.
- The random numbers of a transition are drawn before it, indexed by
  (doubling j, leapfrog i) (:class:`NutsRands`), so a lane's numbers
  never depend on how long the other lanes ran. They are exactly the
  draws JAX's ``_nuts_step`` makes from its key, so tests can feed both
  the same numbers (:func:`run_nuts_with`).
- :func:`run_nuts`: dual-averaging step-size warmup pooled over chains
  and the two-stage diagonal mass, then the sampling phase, every number
  from one ``torch.Generator`` on the run's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F


def make_unconstrained(lnpost_theta: Callable, lo, hi):
    """Wrap a batched box-bounded log-density, (C, D) -> (C,), into an
    unconstrained one: theta = lo + (hi - lo) * sigmoid(y).

    Returns ``(lnpost_y, to_theta, to_y)``, all batched.
    """
    span = hi - lo
    log_span = torch.log(span)

    def to_theta(y):
        return lo + span * torch.sigmoid(y)

    def to_y(theta):
        p = torch.clamp((theta - lo) / span, 1e-9, 1 - 1e-9)
        return torch.log(p) - torch.log1p(-p)

    def lnpost_y(y):
        # log|dtheta/dy| = sum log(span * sig * (1 - sig))
        log_jac = (log_span + F.logsigmoid(y) + F.logsigmoid(-y)).sum(-1)
        return lnpost_theta(to_theta(y)) + log_jac

    return lnpost_y, to_theta, to_y


def value_and_grad(lnpost_y: Callable):
    """(C, D) -> ((C,) values, (C, D) gradients) by autograd of the
    batched ``lnpost_y`` (the chains are independent, so the gradient of
    the sum is each chain's gradient)."""
    def vg(y):
        with torch.enable_grad():
            y = y.detach().requires_grad_(True)
            v = lnpost_y(y)
            (g,) = torch.autograd.grad(v.sum(), y)
        return v.detach(), g

    return vg


def resample_bad_starts(lnpost_y, y0, generator: torch.Generator,
                        gap: float = 1000.0, k_mad: float = 10.0,
                        jitter: float = 0.05):
    """Replace catastrophically bad chain starts before warmup.

    A start far below the typical set diverges on every transition, never
    moves, and its alpha ~ 0 drags the pooled dual-averaging step size
    down for every chain. Bad = non-finite, or below ``median - k_mad *
    MAD`` of the start lnp AND more than ``gap`` below the best (the JAX
    package's rule; medians average the two middle values, as
    ``jnp.nanmedian``). Bad rows become good rows chosen uniformly plus
    Gaussian ``jitter`` in y. If no start is good the input comes back
    unchanged. Returns ``(y0', good_mask)``.
    """
    with torch.no_grad():
        lnp0 = lnpost_y(y0)
    fin = torch.isfinite(lnp0)
    nan = torch.full_like(lnp0, math.nan)
    med = torch.nanquantile(torch.where(fin, lnp0, nan), 0.5)
    mad = torch.nanquantile(torch.where(fin, (lnp0 - med).abs(), nan), 0.5)
    best = torch.where(fin, lnp0, torch.full_like(lnp0, -math.inf)).max()
    outlier = (lnp0 < med - k_mad * mad) & (lnp0 < best - gap)
    good = fin & ~outlier
    if not bool(good.any()):            # start-up only: one host sync
        return y0, good
    nchains = y0.shape[0]
    idx = torch.multinomial(good.to(y0.dtype), nchains, replacement=True,
                            generator=generator)
    donors = y0[idx] + jitter * torch.randn(
        y0.shape, generator=generator, dtype=y0.dtype, device=y0.device)
    return torch.where(good[:, None], y0, donors), good


class NutsRands(NamedTuple):
    """The random numbers of one transition of C chains, drawn before
    it. In JAX's ``_nuts_step`` terms: ``p0`` from ``k_mom``; for doubling
    j, ``go_right[:, j]`` from ``k_d``, ``u_sub[:, j]`` from ``k_b`` and
    ``u_take[:, j, i]`` from the i-th key of the chain split off
    ``k_swap`` (leapfrog i of that doubling)."""

    p0: torch.Tensor          # (C, D) momenta
    go_right: torch.Tensor    # (C, md) bool
    u_take: torch.Tensor      # (C, md, 2^(md-1)) U(0,1)
    u_sub: torch.Tensor       # (C, md) U(0,1)


@dataclass
class NutsCounts:
    """Work of a run, counted on the host: each transition and each
    batched leapfrog step is one value-and-gradient call."""

    transitions: int = 0      # batched transitions
    leapfrogs: int = 0        # batched leapfrog steps
    syncs: int = 0            # any-lane-running reads from the device
    max_leapfrogs: int = 0    # most batched leapfrogs of one transition
    lane_leapfrogs: object = 0.0   # (device) sum over lanes of the
                                   # leapfrogs each lane needed


class _Traj(NamedTuple):
    y_minus: torch.Tensor
    p_minus: torch.Tensor
    g_minus: torch.Tensor     # cached gradient at y_minus
    y_plus: torch.Tensor
    p_plus: torch.Tensor
    g_plus: torch.Tensor
    y_prop: torch.Tensor      # current multinomial proposal
    v_prop: torch.Tensor      # lnpost at the proposal
    lw_prop: torch.Tensor     # its log weight (lnpost - 0.5 p^2)
    lw_sum: torch.Tensor      # logsumexp of trajectory weights
    turning: torch.Tensor
    diverged: torch.Tensor
    sum_alpha: torch.Tensor   # acceptance-statistic accumulator
    n_alpha: torch.Tensor


def _uturn(y_minus, y_plus, p_minus, p_plus):
    dy = y_plus - y_minus
    return ((dy * p_minus).sum(-1) < 0.0) | ((dy * p_plus).sum(-1) < 0.0)


def _subtree_turn(go_right, ck_y, y_n, ck_p, p_n):
    """Trajectory-ordered U-turn decision for one sub-subtree window:
    ``ck`` is the window's opening edge in integration order. Leftward
    windows swap both pairs (leapfrog with -eps keeps forward-convention
    momenta; see the JAX package's docstring)."""
    return torch.where(go_right, _uturn(ck_y, y_n, ck_p, p_n),
                       _uturn(y_n, ck_y, p_n, ck_p))


def _sel(mask, new, old):
    """Per-lane select: ``mask`` (C,) over (C,) or (C, D) tensors."""
    return torch.where(mask if new.dim() == 1 else mask[:, None], new, old)


def _nuts_step(value_and_grad, max_doublings: int, eps, rands: NutsRands,
               y0, counts: NutsCounts = None):
    """One NUTS transition of C chains, (C, D) -> ``(y, v, accept_stat,
    diverged)``, each per chain.

    The doubling loop and the per-subtree leapfrog loop run over the
    whole batch; a lane leaves the doubling loop when its trajectory
    U-turns or diverges, and a subtree's leapfrog loop when its subtree
    does, and its state is frozen from then on. ``eps`` is a scalar or
    per-chain (C,). ``value_and_grad``: (C, D) -> ((C,), (C, D)).
    """
    nchains = y0.shape[0]
    md = max_doublings
    eps_c = torch.as_tensor(eps, dtype=y0.dtype,
                            device=y0.device).expand(nchains)
    p0 = rands.p0
    v0, g0 = value_and_grad(y0)
    lw0 = v0 - 0.5 * (p0 * p0).sum(-1)
    ninf = torch.full_like(v0, -math.inf)
    false = torch.zeros_like(v0, dtype=torch.bool)
    zero = torch.zeros_like(v0)
    traj = _Traj(y0, p0, g0, y0, p0, g0, y0, v0, lw0, lw0, false, false,
                 zero, zero)
    n_lf = 0
    for j in range(md):
        active = ~(traj.turning | traj.diverged)
        if counts is not None:
            counts.syncs += 1
        if not bool(active.any()):
            break
        go = rands.go_right[:, j]
        y = _sel(go, traj.y_plus, traj.y_minus)
        p = _sel(go, traj.p_plus, traj.p_minus)
        g = _sel(go, traj.g_plus, traj.g_minus)
        eps_s = torch.where(go, eps_c, -eps_c)[:, None]

        # the subtree: up to 2^j leapfrogs from the chosen end, each
        # lane stopping at its own U-turn or divergence; leaf i opens the
        # scale-k window when i % 2^k == 0 and closes it when
        # (i + 1) % 2^k == 0 (k = 1..j, j included: the subtree's span)
        lw_sum, y_prop, v_prop, lw_prop = ninf, y, ninf, ninf
        div, turning = traj.diverged, false
        s_alpha, n_done = zero, zero
        ck_y, ck_p = {}, {}
        running = active
        for i in range(1 << j):
            if i:
                if counts is not None:
                    counts.syncs += 1
                if not bool(running.any()):
                    break
            p_half = p + 0.5 * eps_s * g
            y_n = y + eps_s * p_half
            v_n, g_n = value_and_grad(y_n)
            n_lf += 1
            p_n = p_half + 0.5 * eps_s * g_n
            lw = v_n - 0.5 * (p_n * p_n).sum(-1)
            div_n = div | ~torch.isfinite(lw) | (lw0 - lw > 1000.0)
            lw = torch.where(div_n, ninf, lw)
            lw_sum_n = torch.logaddexp(lw_sum, lw)
            take = torch.log(rands.u_take[:, j, i]) < lw - lw_sum_n
            turn_n = turning
            for k in range(1, j + 1):
                if i % (1 << k) == 0:
                    ck_y[k], ck_p[k] = y_n, p_n
                if (i + 1) % (1 << k) == 0:
                    turn_n = turn_n | _subtree_turn(go, ck_y[k], y_n,
                                                    ck_p[k], p_n)
            r = running
            y, p, g = _sel(r, y_n, y), _sel(r, p_n, p), _sel(r, g_n, g)
            rt = r & take
            y_prop = _sel(rt, y_n, y_prop)
            v_prop = _sel(rt, v_n, v_prop)
            lw_prop = _sel(rt, lw, lw_prop)
            lw_sum = _sel(r, lw_sum_n, lw_sum)
            s_alpha = _sel(r, s_alpha + torch.clamp(torch.exp(lw - lw0),
                                                    max=1.0), s_alpha)
            n_done = n_done + r.to(n_done.dtype)
            div = _sel(r, div_n, div)
            turning = _sel(r, turn_n, turning)
            running = r & ~div & ~turning

        # a subtree that diverged or U-turned inside is not merged (no
        # proposal, no weight, no endpoint extension) and the trajectory
        # stops growing (Stan semantics)
        bad_sub = div | turning
        accept_sub = (torch.log(rands.u_sub[:, j]) < lw_sum - traj.lw_sum)
        merge = accept_sub & ~bad_sub
        ext_minus = ~bad_sub & ~go
        ext_plus = ~bad_sub & go
        y_minus = _sel(ext_minus, y, traj.y_minus)
        p_minus = _sel(ext_minus, p, traj.p_minus)
        g_minus = _sel(ext_minus, g, traj.g_minus)
        y_plus = _sel(ext_plus, y, traj.y_plus)
        p_plus = _sel(ext_plus, p, traj.p_plus)
        g_plus = _sel(ext_plus, g, traj.g_plus)
        new = _Traj(
            y_minus, p_minus, g_minus, y_plus, p_plus, g_plus,
            _sel(merge, y_prop, traj.y_prop),
            _sel(merge, v_prop, traj.v_prop),
            _sel(merge, lw_prop, traj.lw_prop),
            torch.logaddexp(traj.lw_sum, torch.where(bad_sub, ninf, lw_sum)),
            traj.turning | turning | _uturn(y_minus, y_plus, p_minus,
                                            p_plus),
            traj.diverged | div,
            # over the leapfrogs actually computed (Stan's estimator)
            traj.sum_alpha + s_alpha,
            traj.n_alpha + n_done)
        traj = _Traj(*(_sel(active, a, b) for a, b in zip(new, traj)))
    if counts is not None:
        counts.transitions += 1
        counts.leapfrogs += n_lf
        counts.max_leapfrogs = max(counts.max_leapfrogs, n_lf)
        counts.lane_leapfrogs = counts.lane_leapfrogs + traj.n_alpha.sum()
    accept_stat = traj.sum_alpha / torch.clamp(traj.n_alpha, min=1.0)
    return traj.y_prop, traj.v_prop, accept_stat, traj.diverged


class NutsRun(NamedTuple):
    samples: torch.Tensor     # (num_samples, C, D), unconstrained y
    lnps: torch.Tensor        # (num_samples, C) lnpost_y at the samples
    alphas: torch.Tensor      # (num_samples, C) acceptance statistics
    eps: torch.Tensor         # adapted step size
    scale: torch.Tensor       # (D,) diagonal mass scale: eps applies to
                              # y' = y / scale
    div_frac: torch.Tensor    # fraction of divergent sampling transitions
    counts: NutsCounts


_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75     # dual-averaging constants


def _dual_averaging(vg, y, draw, phase, nsteps, eps0, max_doublings,
                    target_accept, counts, keep_trace=False):
    """Step-size warmup: ``nsteps`` transitions adapting log eps to the
    chain-pooled mean acceptance statistic. Returns ``(y, eps_bar,
    trace)``; the trace (nsteps, C, D) only with ``keep_trace``."""
    mu = math.log(10.0 * eps0)
    log_eps = torch.full((), math.log(eps0), dtype=y.dtype, device=y.device)
    log_eps_bar = log_eps
    h_bar = torch.zeros_like(log_eps)
    trace = []
    for s in range(nsteps):
        y, _, alpha, _ = _nuts_step(vg, max_doublings, torch.exp(log_eps),
                                    draw(phase, s), y, counts)
        t = s + 1.0
        h_bar = ((1 - 1 / (t + _T0)) * h_bar
                 + (target_accept - alpha.mean()) / (t + _T0))
        log_eps = mu - math.sqrt(t) / _GAMMA * h_bar
        w = t ** (-_KAPPA)
        log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
        if keep_trace:
            trace.append(y)
    return y, torch.exp(log_eps_bar), (torch.stack(trace) if keep_trace
                                       else None)


def run_nuts_with(draw: Callable, lnpost_y: Callable, y0, num_warmup: int,
                  num_samples: int, max_doublings: int = 8,
                  target_accept: float = 0.8, init_step: float = 0.1,
                  adapt_mass: bool = True) -> NutsRun:
    """Run C NUTS chains from ``y0`` (C, D) on the batched ``lnpost_y``,
    taking each transition's numbers from ``draw(phase, t)`` ->
    :class:`NutsRands`: phase ``"a"`` (the first or only warmup stage),
    ``"b"`` (the warmup stage after the mass estimate) or ``"s"``
    (sampling), ``t`` the transition's index in its phase.

    With ``adapt_mass`` and ``num_warmup >= 40`` warmup has two stages:
    stage A adapts the step size with identity mass, a diagonal mass is
    estimated from the second half of stage A's states (all chains
    pooled), and stage B re-adapts the step size from ``init_step`` in
    the rescaled coordinates y' = y / scale. The JAX package's constants
    and order of operations throughout (``run_nuts``,
    ``lumfuncmcmc_tpu/samplers/nuts.py:336``).
    """
    ndim = y0.shape[1]
    counts = NutsCounts()
    vg = value_and_grad(lnpost_y)
    if adapt_mass and num_warmup >= 40:
        n_a = num_warmup // 2
        y, _, trace = _dual_averaging(vg, y0, draw, "a", n_a, init_step,
                                      max_doublings, target_accept, counts,
                                      keep_trace=True)
        var = trace[n_a // 2:].reshape(-1, ndim).var(dim=0, unbiased=False)
        scale = torch.sqrt(torch.clamp(var, min=1e-10))
        vg_s = value_and_grad(lambda yp: lnpost_y(yp * scale))
        y_run, eps, _ = _dual_averaging(vg_s, y / scale, draw, "b",
                                        num_warmup - n_a, init_step,
                                        max_doublings, target_accept,
                                        counts)
    else:
        y_run, eps, _ = _dual_averaging(vg, y0, draw, "a", num_warmup,
                                        init_step, max_doublings,
                                        target_accept, counts)
        scale = torch.ones(ndim, dtype=y0.dtype, device=y0.device)
        vg_s = value_and_grad(lambda yp: lnpost_y(yp * scale))

    samples = torch.empty((num_samples,) + tuple(y0.shape), dtype=y0.dtype,
                          device=y0.device)
    lnps = torch.empty(samples.shape[:2], dtype=y0.dtype, device=y0.device)
    alphas = torch.empty_like(lnps)
    divs = torch.empty_like(lnps, dtype=torch.bool)
    for s in range(num_samples):
        y_run, lnps[s], alphas[s], divs[s] = _nuts_step(
            vg_s, max_doublings, eps, draw("s", s), y_run, counts)
        samples[s] = y_run * scale
    return NutsRun(samples, lnps, alphas, eps, scale,
                   divs.to(y0.dtype).mean(), counts)


def generator_draw(generator: torch.Generator, nchains: int, ndim: int,
                   max_doublings: int, dtype, device):
    """``draw(phase, t)`` for :func:`run_nuts_with` that takes every
    number from ``generator`` on ``device`` (phase and index unused: the
    stream is consumed in transition order)."""
    md = max_doublings

    def draw(phase, t):
        kw = dict(generator=generator, dtype=dtype, device=device)
        return NutsRands(
            p0=torch.randn((nchains, ndim), **kw),
            go_right=torch.rand((nchains, md), **kw) < 0.5,
            u_take=torch.rand((nchains, md, 1 << (md - 1)), **kw),
            u_sub=torch.rand((nchains, md), **kw))

    return draw


def run_nuts(lnpost_y: Callable, y0, generator: torch.Generator,
             num_warmup: int, num_samples: int, max_doublings: int = 8,
             target_accept: float = 0.8, init_step: float = 0.1,
             adapt_mass: bool = True) -> NutsRun:
    """:func:`run_nuts_with` drawing every number from ``generator``."""
    draw = generator_draw(generator, y0.shape[0], y0.shape[1],
                          max_doublings, y0.dtype, y0.device)
    return run_nuts_with(draw, lnpost_y, y0, num_warmup, num_samples,
                         max_doublings=max_doublings,
                         target_accept=target_accept, init_step=init_step,
                         adapt_mass=adapt_mass)
