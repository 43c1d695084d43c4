"""Chain diagnostics: integrated autocorrelation time, ESS, R-hat (port
of ``lumfuncmcmc_tpu/samplers/diagnostics.py``).

Host-side numpy, run once per fit on the fetched chain. The normal
quantile of the rank normalisation is ``torch.special.ndtri``.
"""

from __future__ import annotations

import numpy as np
import torch


def _next_pow2(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def integrated_autocorr_time(chain, c: float = 5.0):
    """Integrated autocorrelation time per parameter.

    ``chain``: (nsteps, nwalkers, ndim). Uses the emcee estimator: the
    ACF of each walker is averaged, tau = 2 cumsum(rho) - 1, and the
    summation window M is the smallest index with M >= c * tau(M)
    (Sokal's auto-windowing). All walker/parameter ACFs come from one
    batched FFT along the step axis.
    """
    chain = np.asarray(chain, dtype=np.float64)
    nsteps, nwalkers, ndim = chain.shape
    n = _next_pow2(nsteps)
    x = chain - chain.mean(axis=0, keepdims=True)
    f = np.fft.fft(x, n=2 * n, axis=0)
    acf = np.fft.ifft(f * np.conjugate(f), axis=0)[:nsteps].real
    acf0 = acf[0].copy()
    acf0[acf0 == 0] = 1.0
    rho = (acf / acf0).mean(axis=1)            # (nsteps, ndim)

    taus = np.empty(ndim)
    steps = np.arange(nsteps)
    for d in range(ndim):
        tau_cum = 2.0 * np.cumsum(rho[:, d]) - 1.0
        # Sokal auto-window: smallest M with M >= c * tau(M)
        too_small = steps < c * tau_cum
        m = int(np.argmin(too_small)) if not too_small.all() \
            else nsteps - 1
        taus[d] = tau_cum[m]
    return taus


def effective_sample_size(chain, c: float = 5.0):
    """ESS per parameter = nsteps*nwalkers / tau."""
    chain = np.asarray(chain)
    n = chain.shape[0] * chain.shape[1]
    return n / np.maximum(integrated_autocorr_time(chain, c), 1.0)


def gelman_rubin(chain):
    """Split-R-hat per parameter; chain (nsteps, nwalkers, ndim)."""
    x = np.asarray(chain, dtype=np.float64)
    n = x.shape[0] // 2
    halves = np.concatenate([x[:n], x[n:2 * n]], axis=1)  # (n, 2W, D)
    means = halves.mean(axis=0)                  # (2W, D)
    variances = halves.var(axis=0, ddof=1)       # (2W, D)
    w = variances.mean(axis=0)
    b = n * means.var(axis=0, ddof=1)
    var_post = (n - 1) / n * w + b / n
    return np.sqrt(var_post / np.maximum(w, 1e-300))


def gelman_rubin_ensembles(chains):
    """Multi-chain split-R-hat across independent ensembles.

    ``chains``: (C, nsteps, nwalkers, ndim). Walkers inside one ensemble
    interact every step, so the independent unit is the whole ensemble:
    each is split in half along steps, the walker samples of a half
    pooled, and B/W computed over the 2C groups. Needs C >= 2.
    """
    x = np.asarray(chains, dtype=np.float64)
    if x.ndim != 4 or x.shape[0] < 2:
        raise ValueError("need (C>=2, nsteps, nwalkers, ndim) chains")
    c, n, w, d = x.shape
    if n < 2:
        raise ValueError(
            f"need >= 2 recorded post-burn-in steps to split, got {n}")
    half = n // 2
    groups = np.concatenate([x[:, :half], x[:, half:2 * half]],
                            axis=0)                  # (2C, half, W, D)
    flat = groups.reshape(2 * c, half * w, d)
    means = flat.mean(axis=1)                        # (2C, D)
    variances = flat.var(axis=1, ddof=1)             # (2C, D)
    w_within = variances.mean(axis=0)
    m = flat.shape[1]
    b = m * means.var(axis=0, ddof=1)
    var_post = (m - 1) / m * w_within + b / m
    return np.sqrt(var_post / np.maximum(w_within, 1e-300))


def _norm_ppf(p):
    """Standard-normal quantile, in float64 on the host."""
    arg = torch.as_tensor(np.asarray(p, dtype=np.float64))
    return torch.special.ndtri(arg).numpy()


def _average_ranks(v):
    """1-based ranks with ties sharing their AVERAGE rank (scipy
    'average' method). MCMC chains contain many exact ties (rejected
    proposals repeat walker positions); argsort-order tie-breaking
    would hand tied samples artificially distinct normal scores and
    perturb the rank-normalized R-hat relative to the Vehtari et al.
    2021 definition (ADVICE r3)."""
    order = np.argsort(v, kind="stable")
    sv = v[order]
    new_grp = np.empty(len(v), dtype=bool)
    new_grp[0] = True
    np.not_equal(sv[1:], sv[:-1], out=new_grp[1:])
    grp = np.cumsum(new_grp) - 1
    counts = np.bincount(grp)
    csum = np.cumsum(counts)
    # group spans sorted positions [csum-count, csum): ranks
    # csum-count+1 .. csum, whose average is (csum-count+csum+1)/2
    avg = (2.0 * csum - counts + 1.0) / 2.0
    ranks = np.empty(len(v), dtype=np.float64)
    ranks[order] = avg[grp]
    return ranks


def _rank_normalize(x):
    """Rank-normalize samples jointly across chains (Vehtari et al.
    2021 eq. 14: fractional average ranks (r - 3/8)/(S + 1/4) through
    the normal quantile). ``x``: (n, m, d)."""
    n, m, d = x.shape
    flat = x.reshape(n * m, d)
    ranks = np.stack([_average_ranks(flat[:, j]) for j in range(d)],
                     axis=1)
    z = _norm_ppf((ranks - 0.375) / (n * m + 0.25))
    return z.reshape(n, m, d)


def rank_normalized_rhat(chain):
    """Rank-normalized split-R-hat, max of bulk and tail (folded)
    variants (Vehtari, Gelman, Simpson, Carpenter & Bürkner 2021).

    The classic split-R-hat compares means, so chains that agree in
    location but disagree in SCALE (or have heavy tails that swamp the
    mean comparison) pass it; the folded variant runs the same
    statistic on |x - median| and catches exactly those, and rank
    normalization makes both defined for infinite-variance chains.
    Same walker-interaction caveat as :func:`gelman_rubin` — for truly
    independent chains use the ensembles variant's grouping.
    """
    x = np.asarray(chain, dtype=np.float64)
    bulk = gelman_rubin(_rank_normalize(x))
    folded = gelman_rubin(_rank_normalize(
        np.abs(x - np.median(x, axis=(0, 1), keepdims=True))))
    return np.maximum(bulk, folded)


def rank_normalized_rhat_ensembles(chains):
    """Rank-normalized (bulk and folded) :func:`gelman_rubin_ensembles`:
    independent ensembles as the chain unit, ranks taken jointly over
    every sample."""
    x = np.asarray(chains, dtype=np.float64)
    c, n, w, d = x.shape

    def z(v):
        return _rank_normalize(v.reshape(c * n, w, d)).reshape(c, n, w, d)

    bulk = gelman_rubin_ensembles(z(x))
    folded = gelman_rubin_ensembles(z(
        np.abs(x - np.median(x, axis=(0, 1, 2), keepdims=True))))
    return np.maximum(bulk, folded)


def mcse_quantile(chain, q: float):
    """Monte-Carlo standard error of the empirical q-quantile, in
    VALUE units, per parameter.

    The autocorrelation-aware ESS of the indicator ``I(x <= xi_q)``
    gives the sampling sd of the quantile's probability level,
    ``sigma_p = sqrt(q(1-q)/ESS_I)``; mapping ``q +- sigma_p`` through
    the empirical quantile function converts it to value units with no
    density estimate (the Vehtari et al. 2021 / posterior-package
    construction). ``chain``: (nsteps, nwalkers, ndim).
    """
    x = np.asarray(chain, dtype=np.float64)
    n, w, d = x.shape
    flat = x.reshape(n * w, d)
    xi = np.quantile(flat, q, axis=0)
    ind = (x <= xi[None, None, :]).astype(np.float64)
    ess = np.maximum(effective_sample_size(ind), 4.0)
    sig_p = np.sqrt(q * (1.0 - q) / ess)
    out = np.empty(d)
    for j in range(d):
        lo = np.quantile(flat[:, j], max(q - sig_p[j], 0.0))
        hi = np.quantile(flat[:, j], min(q + sig_p[j], 1.0))
        out[j] = 0.5 * (hi - lo)
    return out


def burnin_steps(chain, nsteps: int):
    """Reference burn-in rule: min(3 * max tau, nsteps // 2)
    (``lumfuncmcmc.py:499-501``)."""
    tau = np.max(integrated_autocorr_time(chain))
    b = int(tau * 3)
    return min(b, nsteps // 2), tau
