"""Tempered evidence: the rung-batched ladder and parallel tempering (port
of ``lumfuncmcmc_tpu/samplers/tempering.py``).

The marginal likelihood Z = ∫ p(θ) L(θ) dθ is estimated over a
temperature ladder

    lnpost_β(θ) = lnprior(θ) + β · lnlike(θ),   β ∈ [0, 1],

with every rung sampled at once: the rung axis is a leading batch axis
of the red-black ensemble step (``affine._half_step`` /
``_de_half_step``), so each half-step makes ONE ``lnprior_fn`` and ONE
``lnlike_fn`` call over all K x W/2 rows, and each rung draws its
stretch/DE partners inside its own complementary half. On the card
that is one value-kernel launch a half-step for the whole ladder.

Two estimators come from the same ladder (:func:`evidence_from_ladder`):
stepping-stone (primary) and thermodynamic integration, whose gap is
the ladder-resolution check. They return ln[Z(1)/Z(0)], the evidence
under the normalized prior.

Every random draw is taken pre-drawn (:func:`run_tempered_with`,
:func:`run_parallel_tempering_with`) with a leading rung axis on
``affine.run_with_rands``' shapes, so rung k of the ladder is exactly a
``run_with_rands`` run of its tempered posterior on ``rands[k]``; the
generator versions draw them in bulk from one ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.ops.cuda_lnlike import MAX_ROWS
from lumfuncmcmc_tpu_torch.samplers.affine import (
    _de_half_step, _de_rands, _half_step, _stretch_rands, de_schedule)
from lumfuncmcmc_tpu_torch.samplers.diagnostics import effective_sample_size

NEG_INF = -math.inf


def beta_ladder(nrungs: int, power: float = 5.0):
    """Power-law temperature ladder β_k = (k/(K−1))^power, K rungs from
    exactly 0 to exactly 1 (host numpy)."""
    if nrungs < 3:
        raise ValueError("need at least 3 rungs (0, intermediate, 1)")
    k = np.arange(nrungs, dtype=np.float64) / (nrungs - 1)
    return k ** float(power)


def tune_ladder(betas, swap_frac, floor: float = 1e-3):
    """Re-space the ladder to equalize swap rejection across pairs (Syed
    et al. 2021's communication-barrier schedule): Λ(β_k) = Σ_{j<k}
    (1 − swap_frac_j), each rejection floored at ``floor``, inverted at
    equal Λ increments. Endpoints stay exactly 0 and 1 and the result is
    strictly increasing (host numpy)."""
    betas = np.asarray(betas, dtype=np.float64)
    r = 1.0 - np.clip(np.asarray(swap_frac, dtype=np.float64), 0.0, 1.0)
    if betas.ndim != 1 or r.shape != (betas.shape[0] - 1,):
        raise ValueError(
            f"swap_frac must have len(betas)-1 entries, got "
            f"{r.shape} for {betas.shape[0]} rungs")
    r = np.maximum(r, floor)
    lam = np.concatenate([[0.0], np.cumsum(r)])
    targets = np.linspace(0.0, lam[-1], betas.shape[0])
    out = np.interp(targets, lam, betas)
    out[0], out[-1] = 0.0, 1.0
    # float ties from extreme floors: repair the interior rungs only,
    # then re-pin the top and back-propagate downward, so β_{K-1} stays
    # exactly 1
    eps = 1e-12
    for i in range(1, out.shape[0] - 1):
        if out[i] <= out[i - 1]:
            out[i] = out[i - 1] + eps
    out[-1] = 1.0
    for i in range(out.shape[0] - 2, 0, -1):
        if out[i] >= out[i + 1]:
            out[i] = out[i + 1] - eps
    return out


def barrier_stats(swap_frac):
    """Communication barrier Λ = Σ_k (1 − s_k) and the DEO round-trip rate
    1/(2 + 2Λ) it implies (Syed et al. 2021, Corollary 1). Host numpy."""
    r = 1.0 - np.clip(np.asarray(swap_frac, dtype=np.float64), 0.0, 1.0)
    lam = float(r.sum())
    return {"lambda": lam, "roundtrip_rate": 1.0 / (2.0 + 2.0 * lam)}


class _Tempered:
    """The ladder's lnprob, (K, m, D) -> (K, m): one ``lnprior_fn`` and
    one ``lnlike_fn`` call over all K x m rows, then each rung's
    ``lp + β lnl`` (the β = 0 guard: ``0 * -inf`` would be NaN on the
    prior rung). The last call's untempered ``lnl`` and ``lp`` stay in
    ``.lnl`` / ``.lp``, so the sampler carries them with its walkers."""

    def __init__(self, lnprior_fn, lnlike_fn, betas):
        self.lnprior_fn, self.lnlike_fn = lnprior_fn, lnlike_fn
        self.b = betas[:, None]

    def tempered(self, lp, lnl):
        t = torch.where(self.b > 0, self.b * lnl, torch.zeros_like(lnl))
        return torch.where(torch.isfinite(lp), lp + t,
                           torch.full_like(lp, NEG_INF))

    def __call__(self, th):
        K, m, D = th.shape
        flat = th.reshape(K * m, D)
        self.lp = self.lnprior_fn(flat).reshape(K, m)
        self.lnl = self.lnlike_fn(flat).reshape(K, m)
        return self.tempered(self.lp, self.lnl)


def _half(rand, de, mv, other, tempered, a, ndim):
    """One rung-batched half-step of the walkers ``mv = (pos, lnp, lnl,
    lp)`` against ``other``'s positions; returns the new ``mv`` and the
    acceptances (K, nh)."""
    pos, lnp, lnl, lp = mv
    if de:
        pos, lnp, acc = _de_half_step(rand, pos, lnp, other, tempered)
    else:
        pos, lnp, acc = _half_step(rand, pos, lnp, other, tempered, a, ndim)
    lnl = torch.where(acc, tempered.lnl, lnl)
    lp = torch.where(acc, tempered.lp, lp)
    return (pos, lnp, lnl, lp), acc


def _ladder_steps(tempered, state, rands, steps, chains, offset, a, move):
    """Steps ``steps`` (a range of step indices into ``rands``) of the
    rung-batched red-black ensemble from ``state = (pos, lnp, lnl, lp)``,
    each (K, W[, D]); the positions go to ``chains[:, offset + i]``.
    Returns ``(state, acc (K, W))``."""
    K, W, ndim = state[0].shape
    nh = W // 2
    acc = torch.zeros((K, W), dtype=state[0].dtype, device=state[0].device)
    if move == "mix":
        sel, sr, dr = rands
    for i, t in enumerate(steps):
        de = move == "de" or (move == "mix" and bool(sel[t]))
        src = rands if move != "mix" else (dr if de else sr)
        r = [x[:, t] for x in src]                     # each (K, 2, nh)
        first = tuple(x[:, :nh] for x in state)
        second = tuple(x[:, nh:] for x in state)
        first, a0 = _half(tuple(x[:, 0] for x in r), de, first, second[0],
                          tempered, a, ndim)
        second, a1 = _half(tuple(x[:, 1] for x in r), de, second, first[0],
                           tempered, a, ndim)
        state = tuple(torch.cat([p, q], dim=1)
                      for p, q in zip(first, second))
        acc += torch.cat([a0, a1], dim=1)
        chains[:, offset + i] = state[0]
    return state, acc


def _start(tempered, pos0):
    """The ladder's state at ``pos0`` (K, W, D): one evaluation."""
    lnp = tempered(pos0)
    return pos0, lnp, tempered.lnl, tempered.lp


def _check_ladder(pos0, move):
    K, W, _ = pos0.shape
    if W % 2:
        raise ValueError("nwalkers must be even for the red-black scheme")
    if move in ("de", "mix") and W < 4:
        raise ValueError(
            "the DE proposal needs nwalkers >= 4 (two distinct partners "
            "in the fixed half-ensemble)")
    if move not in ("stretch", "de", "mix"):
        raise ValueError(f"unknown move {move!r} (stretch|de|mix)")


def recompute_lnl(lnlike_fn: Callable, chains, max_rows: int = MAX_ROWS):
    """Untempered lnlike of every recorded position, (K, S, W, D) ->
    (K, S, W), in row chunks of at most ``max_rows`` (one kernel launch
    each on the card), so memory stays bounded."""
    flat = chains.reshape(-1, chains.shape[-1])
    with torch.no_grad():
        out = torch.cat([lnlike_fn(flat[i:i + max_rows])
                         for i in range(0, flat.shape[0], max_rows)])
    return out.reshape(chains.shape[:3])


def run_tempered_with(lnprior_fn: Callable, lnlike_fn: Callable, pos0, betas,
                      rands, nsteps: int, a: float = 2.0,
                      move: str = "stretch"):
    """Every ladder rung at once over pre-drawn randoms.

    ``pos0``: (K, W, D) per-rung starts; ``betas``: (K,). ``rands``:
    ``affine.run_with_rands``' randoms for ``move``, each tensor with a
    leading rung axis ((K, nsteps, 2, W/2); for "mix" the host schedule
    ``sel`` (nsteps,) is shared by all rungs). ``lnprior_fn`` and
    ``lnlike_fn``: (M, D) -> (M,).

    Returns ``(chains (K, nsteps, W, D), lnls (K, nsteps, W), acc (K,
    W))`` with ``lnls`` the untempered lnlike recomputed on the recorded
    chain (:func:`recompute_lnl`; the sampler's lnp is the tempered
    posterior).
    """
    _check_ladder(pos0, move)
    K, W, D = pos0.shape
    betas = torch.as_tensor(np.asarray(betas), dtype=pos0.dtype,
                            device=pos0.device)
    tempered = _Tempered(lnprior_fn, lnlike_fn, betas)
    chains = torch.empty((K, nsteps, W, D), dtype=pos0.dtype,
                         device=pos0.device)
    with torch.no_grad():
        _, acc = _ladder_steps(tempered, _start(tempered, pos0), rands,
                               range(nsteps), chains, 0, a, move)
    return chains, recompute_lnl(lnlike_fn, chains), acc


def ladder_rands(generator: torch.Generator, K: int, nsteps: int, W: int,
                 ndim: int, dtype, device, move: str = "stretch",
                 de_prob: float = 0.5):
    """Bulk randoms of :func:`run_tempered_with` for ``move``: each rung's
    ``affine`` draws, stacked on a leading rung axis."""
    nh = W // 2

    def stack(draw):
        per = [draw() for _ in range(K)]
        return tuple(torch.stack(x) for x in zip(*per))

    def stretch():
        return stack(lambda: _stretch_rands(generator, nsteps, nh, dtype,
                                            device))

    def de():
        return stack(lambda: _de_rands(generator, nsteps, nh, ndim, dtype,
                                       device))

    if move == "stretch":
        return stretch()
    if move == "de":
        return de()
    if move == "mix":
        return de_schedule(nsteps, de_prob), stretch(), de()
    raise ValueError(f"unknown move {move!r} (stretch|de|mix)")


def run_tempered(lnprior_fn: Callable, lnlike_fn: Callable, pos0, betas,
                 generator: torch.Generator, nsteps: int, a: float = 2.0,
                 move: str = "stretch", de_prob: float = 0.5):
    """:func:`run_tempered_with` on randoms drawn from ``generator`` (on
    ``pos0``'s device)."""
    K, W, D = pos0.shape
    rands = ladder_rands(generator, K, nsteps, W, D, pos0.dtype, pos0.device,
                         move, de_prob)
    return run_tempered_with(lnprior_fn, lnlike_fn, pos0, betas, rands,
                             nsteps, a=a, move=move)


def _exchange(x, do):
    """``x`` (K, W, ...) with rungs k and k+1 exchanged in the columns
    where ``do`` (K-1, W) holds (the active pairs are disjoint)."""
    up = torch.nn.functional.pad(do, (0, 0, 0, 1))     # k trades with k+1
    dn = torch.nn.functional.pad(do, (0, 0, 1, 0))     # k trades with k-1
    shape = up.shape + (1,) * (x.dim() - 2)
    out = torch.where(up.reshape(shape), torch.roll(x, -1, 0), x)
    return torch.where(dn.reshape(shape), torch.roll(x, 1, 0), out)


def _pair_swap_block(pos, lnl, db, u, active):
    """Adjacent-pair replica exchange over a block of n rungs: ``pos (n,
    W, D)``, ``lnl (n, W)``, pair i = (rung i, rung i+1) with gap ``db
    (n-1,)``, uniforms ``u (n-1, W)`` and activity mask ``active
    (n-1,)``, the active pairs disjoint. Returns ``(pos', lnl', do (n-1,
    W))``."""
    ln_r = db[:, None] * (lnl[:-1] - lnl[1:])
    do = (torch.log(u) < ln_r) & active[:, None]
    return _exchange(pos, do), _exchange(lnl, do), do


def _deo_swap(pos, lnl, betas, u, phase):
    """One DEO swap phase over the whole ladder: the pairs whose left
    rung index has parity ``phase`` exchange."""
    active = (torch.arange(betas.shape[0] - 1, device=pos.device) % 2
              ) == phase
    return _pair_swap_block(pos, lnl, betas[1:] - betas[:-1], u, active)


def run_parallel_tempering_with(lnprior_fn: Callable, lnlike_fn: Callable,
                                pos0, betas, rands, u, nsteps: int,
                                swap_every: int = 10, a: float = 2.0,
                                move: str = "stretch", lnls: bool = True):
    """The ladder of :func:`run_tempered_with` plus DEO replica-exchange
    swaps every ``swap_every`` steps: round r runs steps [r s, (r+1) s)
    of ``rands``, then exchanges the pairs of parity ``r % 2`` with the
    uniforms ``u[r]`` (R, K-1, W). The walkers carry their untempered
    lnlike and lnprior through the swaps, so the ladder is evaluated
    once at the start and once a half-step, whatever the swaps.

    Returns ``(chains (K, R s, W, D), lnls (K, R s, W) or None when
    ``lnls`` is False, acc (K, W), swap_frac (K-1,) numpy, swaps (R,
    K-1, W))``: ``swap_frac`` is each pair's acceptance over the rounds
    it was active.
    """
    if swap_every <= 0:
        raise ValueError("swap_every must be positive (use run_tempered "
                         "for the swapless ladder)")
    nrounds = nsteps // swap_every
    if nrounds < 1:
        raise ValueError(f"nsteps={nsteps} < swap_every={swap_every}: no "
                         "full round would run")
    _check_ladder(pos0, move)
    K, W, D = pos0.shape
    betas = torch.as_tensor(np.asarray(betas), dtype=pos0.dtype,
                            device=pos0.device)
    tempered = _Tempered(lnprior_fn, lnlike_fn, betas)
    n = nrounds * swap_every
    chains = torch.empty((K, n, W, D), dtype=pos0.dtype, device=pos0.device)
    acc = torch.zeros((K, W), dtype=pos0.dtype, device=pos0.device)
    swaps = []
    with torch.no_grad():
        state = _start(tempered, pos0)
        for r in range(nrounds):
            lo = r * swap_every
            state, acc_r = _ladder_steps(
                tempered, state, rands, range(lo, lo + swap_every), chains,
                lo, a, move)
            acc += acc_r
            pos, _, lnl, lp = state
            pos, lnl, do = _deo_swap(pos, lnl, betas, u[r], r % 2)
            lp = _exchange(lp, do)
            state = (pos, tempered.tempered(lp, lnl), lnl, lp)
            swaps.append(do)
    swaps = torch.stack(swaps)
    active = np.asarray([(nrounds + (1 if k % 2 == 0 else 0)) // 2
                         for k in range(K - 1)], dtype=np.float64)
    swap_frac = (swaps.double().mean(dim=2).sum(dim=0).cpu().numpy()
                 / np.maximum(active, 1.0))
    return (chains, recompute_lnl(lnlike_fn, chains) if lnls else None,
            acc, swap_frac, swaps)


def run_parallel_tempering(lnprior_fn: Callable, lnlike_fn: Callable, pos0,
                           betas, generator: torch.Generator, nsteps: int,
                           swap_every: int = 10, a: float = 2.0,
                           move: str = "stretch", de_prob: float = 0.5,
                           lnls: bool = True):
    """:func:`run_parallel_tempering_with` on randoms drawn from
    ``generator``: the steps' draws, then the swaps' uniforms. Returns
    ``(chains, lnls, acc, swap_frac)``, the JAX function's four."""
    K, W, D = pos0.shape
    nrounds = nsteps // swap_every if swap_every > 0 else 0
    rands = ladder_rands(generator, K, nrounds * swap_every, W, D,
                         pos0.dtype, pos0.device, move, de_prob)
    u = torch.rand((nrounds, K - 1, W), generator=generator,
                   dtype=pos0.dtype, device=pos0.device)
    return run_parallel_tempering_with(
        lnprior_fn, lnlike_fn, pos0, betas, rands, u, nsteps,
        swap_every=swap_every, a=a, move=move, lnls=lnls)[:4]


def evidence_from_ladder(lnls, betas, burn_frac: float = 0.5):
    """TI + stepping-stone ln Z from per-rung lnlike chains (host numpy).

    ``lnls``: (K, S, W) untempered lnlike in ladder order; ``betas``:
    (K,) ascending from 0 to 1; ``burn_frac`` of each rung's chain is
    discarded. Returns ``lnz_ss`` (primary) with its delta-method
    standard error ``lnz_ss_err`` (autocorrelation-aware ESS of each
    ratio's summand, the rung variances added), ``lnz_ti`` with
    ``lnz_ti_err``, the per-rung ``mean_lnl`` curve and the ladder.
    """
    lnls = np.asarray(lnls, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    K, S, W = lnls.shape
    burn = min(int(burn_frac * S), S - 2)
    post = lnls[:, burn:, :]                    # (K, S', W)
    flat = post.reshape(K, -1)
    e = flat.mean(axis=1)

    lnz_ti = float(np.trapezoid(e, betas))

    def log_mean_exp(x):
        m = np.max(x)
        if not np.isfinite(m):
            return float(m)
        return float(m + np.log(np.mean(np.exp(x - m))))

    db = np.diff(betas)
    lnz_ss = 0.0
    var_ss = 0.0
    for k in range(K - 1):
        lnz_ss += log_mean_exp(db[k] * flat[k])
        x = db[k] * post[k]                       # (S', W)
        m = np.max(x)
        if np.isfinite(m):
            y = np.exp(x - m)
            ess_y = float(effective_sample_size(
                y[:, :, None]).min()) if y.std() > 0 else y.size
            mu = float(y.mean())
            var_ss += float(y.var()) / (max(ess_y, 1.0) * mu * mu)
    lnz_ss_err = float(np.sqrt(var_ss))

    w = np.zeros(K)
    w[0] = db[0] / 2.0
    w[-1] = db[-1] / 2.0
    w[1:-1] = (db[:-1] + db[1:]) / 2.0
    sem = np.empty(K)
    for k in range(K):
        ess = float(effective_sample_size(post[k][:, :, None]).min())
        sem[k] = flat[k].std() / np.sqrt(max(ess, 1.0))
    lnz_ti_err = float(np.sqrt(np.sum((w * sem) ** 2)))

    return {
        "lnz_ss": lnz_ss,
        "lnz_ss_err": lnz_ss_err,
        "lnz_ti": lnz_ti,
        "lnz_ti_err": lnz_ti_err,
        "betas": betas,
        "mean_lnl": e,
        "nrungs": K,
        "samples_per_rung": flat.shape[1],
    }
