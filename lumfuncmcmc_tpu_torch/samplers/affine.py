"""Affine-invariant ensemble sampler (port of
``lumfuncmcmc_tpu/samplers/affine.py``).

Goodman & Weare stretch move, differential evolution, and a
deterministic mix of the two. The two half-ensembles update in the
red-black scheme: the second half moves against the already-updated
first half, as emcee's ``RedBlueMove`` does.

Every random draw of a run is generated in bulk before the loop, from
one ``torch.Generator`` on the run's device, with the JAX package's
shapes. The step loop is a Python loop that never synchronises with the
device: the chain goes into a preallocated device tensor and
acceptances are counted on the device. On the card a stretch half-step
is two hand-written kernels around its one lnprob call
(``ops/stretch.py``: the proposal, then the accept step), with the eager
ops' bits.

Independent replicated ensembles (:func:`run_stretch_ensembles`) are a
leading batch axis of the walkers, as the tempered ladder's rungs are:
each half-step makes one ``lnprob_batch`` call over all E x W/2 rows,
and each ensemble draws its partners from its own other half.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.ops.stretch import stretch_accept, stretch_propose
from lumfuncmcmc_tpu_torch.utils.tracing import span


class EnsembleState(NamedTuple):
    pos: torch.Tensor      # (nwalkers, ndim)
    lnp: torch.Tensor      # (nwalkers,)


def _pick(other_pos, j):
    """Rows ``j`` of the fixed half: ``other_pos`` (n, D) with ``j``
    (m,), or a batch of halves (K, n, D) with ``j`` (K, m), each batch
    entry taking its partners from its own half."""
    return torch.take_along_dim(other_pos, j[..., None], dim=-2)


def _half_step(rand, move_pos, move_lnp, other_pos, lnprob_batch, a, ndim):
    """Stretch-move one half-ensemble against the fixed other half.
    ``rand = (u_z, j, ln_u)``: per-walker stretch draw, partner index and
    log acceptance uniform. Leading batch dimensions (the tempered
    ladder's rungs) pass through to ``lnprob_batch``. The proposal and the
    accept step are ``ops/stretch.py``'s: on the card a kernel each around
    the one ``lnprob_batch`` call, on the CPU the eager ops."""
    u_z, j, ln_u = rand
    prop = stretch_propose(move_pos, other_pos, u_z, j, a)
    return stretch_accept(prop, lnprob_batch(prop), move_pos, move_lnp, u_z,
                          ln_u, a, ndim)


def _de_half_step(rand, move_pos, move_lnp, other_pos, lnprob_batch):
    """Differential-evolution move for one half-ensemble: proposal
    x' = x + g * (x_a - x_b) with a, b two distinct walkers of the fixed
    half; symmetric proposal, plain Metropolis accept.
    ``rand = (g, j1, j2, ln_u)``."""
    g, j1, j2, ln_u = rand
    diff = _pick(other_pos, j1) - _pick(other_pos, j2)
    prop = move_pos + g[..., None] * diff
    lnp_prop = lnprob_batch(prop)
    accept = ln_u < lnp_prop - move_lnp
    new_pos = torch.where(accept[..., None], prop, move_pos)
    new_lnp = torch.where(accept, lnp_prop, move_lnp)
    return new_pos, new_lnp, accept


def _halves(state: EnsembleState):
    """The two half-ensembles of ``(pos (..., W, D), lnp (..., W))``."""
    pos, lnp = state
    nh = pos.shape[-2] // 2
    return ((pos[..., :nh, :], lnp[..., :nh]),
            (pos[..., nh:, :], lnp[..., nh:]))


def _join(first, second, a0, a1):
    return (EnsembleState(torch.cat([first[0], second[0]], dim=-2),
                          torch.cat([first[1], second[1]], dim=-1)),
            torch.cat([a0, a1], dim=-1))


def _step_de_pre(rands, state: EnsembleState, lnprob_batch: Callable):
    """One full DE step from pre-generated randoms, each (2, ..., nh)."""
    (p0, l0), (p1, l1) = _halves(state)
    g, j1, j2, ln_u = rands
    p0, l0, a0 = _de_half_step((g[0], j1[0], j2[0], ln_u[0]), p0, l0,
                               p1, lnprob_batch)
    p1, l1, a1 = _de_half_step((g[1], j1[1], j2[1], ln_u[1]), p1, l1,
                               p0, lnprob_batch)
    return _join((p0, l0), (p1, l1), a0, a1)


def _step_pre(rands, state: EnsembleState, lnprob_batch: Callable,
              a: float):
    """One full stretch-move step from pre-generated randoms
    ``(u_z, j, ln_u)``, each (2, ..., nh): index 0 moves the first half
    against the second, index 1 the second against the updated first.
    Leading batch dimensions of the walkers (..., W, D) are independent
    ensembles."""
    ndim = state.pos.shape[-1]
    (p0, l0), (p1, l1) = _halves(state)
    u_z, j, ln_u = rands
    p0, l0, a0 = _half_step((u_z[0], j[0], ln_u[0]), p0, l0, p1,
                            lnprob_batch, a, ndim)
    p1, l1, a1 = _half_step((u_z[1], j[1], ln_u[1]), p1, l1, p0,
                            lnprob_batch, a, ndim)
    return _join((p0, l0), (p1, l1), a0, a1)


def step(generator: torch.Generator, state: EnsembleState,
         lnprob_batch: Callable, a: float = 2.0):
    """One full stretch-move step (both halves) with randoms drawn from
    ``generator``, as the first step of :func:`run_stretch` with
    ``nsteps=1`` draws them. Returns ``(state, accepted (W,))``."""
    rands = draw_rands(generator, "stretch", 1, state.pos)
    return _step_pre(tuple(x[0] for x in rands), state, lnprob_batch, a)


def _stretch_rands(gen, nsteps, nh, dtype, device, batch=()):
    """Bulk stretch randoms ``(u_z, j, ln_u)``, each (nsteps, 2,
    *batch, nh)."""
    shape = (nsteps, 2, *batch, nh)
    u_z = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    j = torch.randint(0, nh, shape, generator=gen, device=device)
    ln_u = torch.log(torch.rand(shape, generator=gen, dtype=dtype,
                                device=device))
    return u_z, j, ln_u


def _de_rands(gen, nsteps, nh, ndim, dtype, device, batch=()):
    """Bulk DE randoms: jittered/jumping gamma, two distinct partner
    indices, log accept uniforms — each (nsteps, 2, *batch, nh).
    gamma_0 = 2.38/sqrt(2 ndim) with 1e-5 jitter, and 10% full-strength
    (gamma = 1) jumps."""
    shape = (nsteps, 2, *batch, nh)
    g0 = 2.38 / math.sqrt(2.0 * ndim)
    g = g0 * (1.0 + 1e-5 * torch.randn(shape, generator=gen, dtype=dtype,
                                       device=device))
    jump = torch.rand(shape, generator=gen, dtype=dtype, device=device) < 0.1
    g = torch.where(jump, torch.ones_like(g), g)
    j1 = torch.randint(0, nh, shape, generator=gen, device=device)
    j2 = torch.randint(0, nh - 1, shape, generator=gen, device=device)
    j2 = j2 + (j2 >= j1).to(j2.dtype)           # distinct partners
    ln_u = torch.log(torch.rand(shape, generator=gen, dtype=dtype,
                                device=device))
    return g, j1, j2, ln_u


def de_schedule(nsteps: int, de_prob: float, offset: int = 0):
    """Deterministic Bresenham DE-step selector for global steps
    ``[offset, offset + nsteps)``."""
    t = np.arange(offset, offset + nsteps, dtype=np.float64)
    return np.floor((t + 1) * de_prob) - np.floor(t * de_prob) >= 1.0


def run_with_rands(lnprob_batch: Callable, pos0, rands, nsteps: int,
                   a: float = 2.0, thin: int = 1, move: str = "stretch"):
    """The step loop over pre-generated randoms.

    ``rands``: ``(u_z, j, ln_u)`` for move="stretch", ``(g, j1, j2,
    ln_u)`` for "de", and ``(sel, stretch_rands, de_rands)`` for "mix",
    where ``sel`` is the host (nsteps,) bool DE schedule. ``pos0`` is
    (W, D), or (..., W, D) for independent ensembles with ``rands`` of
    shape (nsteps, 2, ..., W/2) and a ``lnprob_batch`` that takes the
    leading dimensions. Returns ``(state, chain (nsteps//thin, ..., W,
    D), lnp (nsteps//thin, ..., W), acc_count (..., W))``. The loop
    makes no host synchronisation.
    """
    state = EnsembleState(pos0, lnprob_batch(pos0))
    nrec = nsteps // thin
    chain = torch.empty((nrec,) + tuple(pos0.shape), dtype=pos0.dtype,
                        device=pos0.device)
    lnps = torch.empty((nrec,) + tuple(pos0.shape[:-1]), dtype=pos0.dtype,
                       device=pos0.device)
    acc = torch.zeros(pos0.shape[:-1], dtype=pos0.dtype, device=pos0.device)
    if move == "mix":
        sel, sr, dr = rands
    for t in range(nsteps):
        with span("step"):
            if move == "stretch" or (move == "mix" and not sel[t]):
                r = tuple(x[t] for x in (rands if move == "stretch" else sr))
                state, accepted = _step_pre(r, state, lnprob_batch, a)
            else:
                r = tuple(x[t] for x in (rands if move == "de" else dr))
                state, accepted = _step_de_pre(r, state, lnprob_batch)
            acc += accepted
            if (t + 1) % thin == 0:
                chain[t // thin] = state.pos
                lnps[t // thin] = state.lnp
    return state, chain, lnps, acc


def run_stretch(lnprob_batch: Callable, pos0, generator: torch.Generator,
                nsteps: int, a: float = 2.0, thin: int = 1,
                move: str = "stretch", de_prob: float = 0.5, de_sel=None):
    """Run the ensemble for ``nsteps`` full steps.

    ``lnprob_batch``: (m, ndim) -> (m,), or with leading dimensions of
    ``pos0`` (..., W, D) the same leading dimensions in and out.
    ``generator`` lives on ``pos0``'s device and supplies every random
    draw. ``move``: "stretch", "de" or "mix" (the deterministic
    ``de_schedule`` with ``de_prob``; a blocked run passes its slice of
    the global schedule as ``de_sel``, so block boundaries do not
    restart it). With ``thin > 1``, ``nsteps`` must be a multiple of
    ``thin``.

    Returns ``(state, chain (nsteps//thin, ..., W, D), lnp
    (nsteps//thin, ..., W), acc_count (..., W))`` on the device.
    """
    check_run(pos0, nsteps, thin, move)
    rands = draw_rands(generator, move, nsteps, pos0, de_prob, de_sel)
    return run_with_rands(lnprob_batch, pos0, rands, nsteps, a, thin, move)


def check_run(pos0, nsteps: int, thin: int, move: str):
    """:func:`run_stretch`'s argument checks."""
    nwalkers = pos0.shape[-2]
    if nwalkers % 2:
        raise ValueError("nwalkers must be even for the red-black scheme")
    if move in ("de", "mix") and nwalkers < 4:
        raise ValueError(
            "the DE proposal needs nwalkers >= 4 (two distinct "
            "partners in the fixed half-ensemble)")
    if thin > 1 and nsteps % thin:
        raise ValueError(
            f"nsteps={nsteps} must be a multiple of thin={thin}")


def draw_rands(generator: torch.Generator, move: str, nsteps: int, pos0,
               de_prob: float = 0.5, de_sel=None):
    """Every random draw of :func:`run_stretch` from ``pos0`` (..., W, D),
    in its order: :func:`run_with_rands`' ``rands`` for ``move``."""
    nh, ndim = pos0.shape[-2] // 2, pos0.shape[-1]
    kw = dict(dtype=pos0.dtype, device=pos0.device,
              batch=tuple(pos0.shape[:-2]))
    if move == "stretch":
        return _stretch_rands(generator, nsteps, nh, **kw)
    if move == "de":
        return _de_rands(generator, nsteps, nh, ndim, **kw)
    if move == "mix":
        sel = (de_schedule(nsteps, de_prob) if de_sel is None
               else np.asarray(de_sel))
        return (sel, _stretch_rands(generator, nsteps, nh, **kw),
                _de_rands(generator, nsteps, nh, ndim, **kw))
    raise ValueError(f"unknown move {move!r} (stretch|de|mix)")


def flat_batch(lnprob_batch: Callable) -> Callable:
    """(..., m, D) -> (..., m) through one ``lnprob_batch`` call over
    all rows: one kernel launch on the card whatever the batch."""
    def fn(th):
        return lnprob_batch(th.reshape(-1, th.shape[-1])).reshape(
            th.shape[:-1])
    return fn


def _ensemble_major(out):
    state, chain, lnps, acc = out
    return state, chain.transpose(0, 1), lnps.transpose(0, 1), acc


def run_ensembles_with_rands(lnprob_batch: Callable, pos0, rands,
                             nsteps: int, a: float = 2.0, thin: int = 1,
                             move: str = "stretch"):
    """:func:`run_with_rands` for E independent ensembles, ``pos0`` (E, W,
    D), ``rands`` each (nsteps, 2, E, W/2) (the "mix" schedule shared):
    ensemble e runs exactly as ``run_with_rands`` on ``pos0[e]`` and
    ``x[:, :, e]`` of every random. ``lnprob_batch``: (m, D) -> (m,),
    called once a half-step over all E x W/2 rows. Returns ``(state,
    chain (E, nsteps//thin, W, D), lnp (E, nsteps//thin, W), acc (E,
    W))``."""
    return _ensemble_major(run_with_rands(flat_batch(lnprob_batch), pos0,
                                          rands, nsteps, a, thin, move))


def run_stretch_ensembles(lnprob_batch: Callable, pos0,
                          generator: torch.Generator, nsteps: int,
                          a: float = 2.0, thin: int = 1,
                          move: str = "stretch", de_prob: float = 0.5,
                          de_sel=None):
    """Run E independent ensembles at once, ``pos0`` (E, W, D): the
    ensemble axis is a batch axis of every half-step (one
    ``lnprob_batch`` call over all E x W/2 rows), the randoms of all E
    drawn in bulk from ``generator``. Gives a true multi-chain R-hat
    (:func:`~lumfuncmcmc_tpu_torch.samplers.diagnostics.gelman_rubin_ensembles`)
    and fills the card when one ensemble's batch is small. Returns
    :func:`run_stretch`'s tuple with the ensemble axis first: ``(state,
    chain (E, nsteps//thin, W, D), lnp (E, nsteps//thin, W), acc (E,
    W))``."""
    return _ensemble_major(run_stretch(
        flat_batch(lnprob_batch), pos0, generator, nsteps, a, thin, move,
        de_prob, de_sel))
