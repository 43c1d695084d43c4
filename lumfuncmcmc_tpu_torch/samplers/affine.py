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
acceptances are counted on the device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class EnsembleState(NamedTuple):
    pos: torch.Tensor      # (nwalkers, ndim)
    lnp: torch.Tensor      # (nwalkers,)


def _half_step(rand, move_pos, move_lnp, other_pos, lnprob_batch, a, ndim):
    """Stretch-move one half-ensemble against the fixed other half.
    ``rand = (u_z, j, ln_u)``: per-walker stretch draw, partner index and
    log acceptance uniform."""
    u_z, j, ln_u = rand
    z = ((a - 1.0) * u_z + 1.0) ** 2 / a
    partner = other_pos[j]                       # (nmove, ndim)
    prop = partner + z[:, None] * (move_pos - partner)
    lnp_prop = lnprob_batch(prop)
    ln_ratio = (ndim - 1.0) * torch.log(z) + lnp_prop - move_lnp
    accept = ln_u < ln_ratio
    new_pos = torch.where(accept[:, None], prop, move_pos)
    new_lnp = torch.where(accept, lnp_prop, move_lnp)
    return new_pos, new_lnp, accept


def _de_half_step(rand, move_pos, move_lnp, other_pos, lnprob_batch):
    """Differential-evolution move for one half-ensemble: proposal
    x' = x + g * (x_a - x_b) with a, b two distinct walkers of the fixed
    half; symmetric proposal, plain Metropolis accept.
    ``rand = (g, j1, j2, ln_u)``."""
    g, j1, j2, ln_u = rand
    diff = other_pos[j1] - other_pos[j2]
    prop = move_pos + g[:, None] * diff
    lnp_prop = lnprob_batch(prop)
    accept = ln_u < lnp_prop - move_lnp
    new_pos = torch.where(accept[:, None], prop, move_pos)
    new_lnp = torch.where(accept, lnp_prop, move_lnp)
    return new_pos, new_lnp, accept


def _step_de_pre(rands, state: EnsembleState, lnprob_batch: Callable):
    """One full DE step from pre-generated randoms, each (2, nh)."""
    pos, lnp = state
    nh = pos.shape[0] // 2
    g, j1, j2, ln_u = rands
    p0, l0 = pos[:nh], lnp[:nh]
    p1, l1 = pos[nh:], lnp[nh:]
    p0, l0, a0 = _de_half_step((g[0], j1[0], j2[0], ln_u[0]), p0, l0,
                               p1, lnprob_batch)
    p1, l1, a1 = _de_half_step((g[1], j1[1], j2[1], ln_u[1]), p1, l1,
                               p0, lnprob_batch)
    return (EnsembleState(torch.cat([p0, p1]), torch.cat([l0, l1])),
            torch.cat([a0, a1]))


def _step_pre(rands, state: EnsembleState, lnprob_batch: Callable,
              a: float):
    """One full stretch-move step from pre-generated randoms
    ``(u_z, j, ln_u)``, each (2, nh): index 0 moves the first half
    against the second, index 1 the second against the updated first."""
    pos, lnp = state
    nwalkers, ndim = pos.shape
    nh = nwalkers // 2
    u_z, j, ln_u = rands
    p0, l0 = pos[:nh], lnp[:nh]
    p1, l1 = pos[nh:], lnp[nh:]
    p0, l0, a0 = _half_step((u_z[0], j[0], ln_u[0]), p0, l0, p1,
                            lnprob_batch, a, ndim)
    p1, l1, a1 = _half_step((u_z[1], j[1], ln_u[1]), p1, l1, p0,
                            lnprob_batch, a, ndim)
    return (EnsembleState(torch.cat([p0, p1]), torch.cat([l0, l1])),
            torch.cat([a0, a1]))


def _stretch_rands(gen, nsteps, nh, dtype, device):
    """Bulk stretch randoms ``(u_z, j, ln_u)``, each (nsteps, 2, nh)."""
    shape = (nsteps, 2, nh)
    u_z = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    j = torch.randint(0, nh, shape, generator=gen, device=device)
    ln_u = torch.log(torch.rand(shape, generator=gen, dtype=dtype,
                                device=device))
    return u_z, j, ln_u


def _de_rands(gen, nsteps, nh, ndim, dtype, device):
    """Bulk DE randoms: jittered/jumping gamma, two distinct partner
    indices, log accept uniforms — each (nsteps, 2, nh). gamma_0 =
    2.38/sqrt(2 ndim) with 1e-5 jitter, and 10% full-strength
    (gamma = 1) jumps."""
    shape = (nsteps, 2, nh)
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
    where ``sel`` is the host (nsteps,) bool DE schedule. Returns
    ``(state, chain (nsteps//thin, W, D), lnp (nsteps//thin, W),
    acc_count (W,))``. The loop makes no host synchronisation.
    """
    nwalkers, ndim = pos0.shape
    state = EnsembleState(pos0, lnprob_batch(pos0))
    nrec = nsteps // thin
    chain = torch.empty((nrec, nwalkers, ndim), dtype=pos0.dtype,
                        device=pos0.device)
    lnps = torch.empty((nrec, nwalkers), dtype=pos0.dtype,
                       device=pos0.device)
    acc = torch.zeros(nwalkers, dtype=pos0.dtype, device=pos0.device)
    if move == "mix":
        sel, sr, dr = rands
    for t in range(nsteps):
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
                move: str = "stretch", de_prob: float = 0.5):
    """Run the ensemble for ``nsteps`` full steps.

    ``lnprob_batch``: (m, ndim) -> (m,). ``generator`` lives on
    ``pos0``'s device and supplies every random draw. ``move``:
    "stretch", "de" or "mix" (the deterministic ``de_schedule`` with
    ``de_prob``). With ``thin > 1``,
    ``nsteps`` must be a multiple of ``thin``.

    Returns ``(state, chain (nsteps//thin, W, D), lnp (nsteps//thin, W),
    acc_count (W,))`` on the device.
    """
    nwalkers, ndim = pos0.shape
    if nwalkers % 2:
        raise ValueError("nwalkers must be even for the red-black scheme")
    if move in ("de", "mix") and nwalkers < 4:
        raise ValueError(
            "the DE proposal needs nwalkers >= 4 (two distinct "
            "partners in the fixed half-ensemble)")
    if thin > 1 and nsteps % thin:
        raise ValueError(
            f"nsteps={nsteps} must be a multiple of thin={thin}")
    nh = nwalkers // 2
    dt, dev = pos0.dtype, pos0.device
    if move == "stretch":
        rands = _stretch_rands(generator, nsteps, nh, dt, dev)
    elif move == "de":
        rands = _de_rands(generator, nsteps, nh, ndim, dt, dev)
    elif move == "mix":
        rands = (de_schedule(nsteps, de_prob),
                 _stretch_rands(generator, nsteps, nh, dt, dev),
                 _de_rands(generator, nsteps, nh, ndim, dt, dev))
    else:
        raise ValueError(f"unknown move {move!r} (stretch|de|mix)")
    return run_with_rands(lnprob_batch, pos0, rands, nsteps, a, thin, move)
