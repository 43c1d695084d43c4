"""Predictive information criteria: WAIC and PSIS-LOO (port of
``lumfuncmcmc_tpu/models/ic.py``).

The Poisson point process factorizes, given the observed count N, into
N iid per-source densities

    ln p(x_i | theta, N) = ln lambda(x_i) - ln Lam(theta)
    ln L(theta) = sum_i ln p(x_i | theta, N) + [N ln Lam - Lam]

(the bracket is the count term, reported apart as ``count_*``). WAIC
(Watanabe 2010) and PSIS-LOO (Vehtari, Gelman & Gabry 2017) come from
the posterior draws a fit already made; ``max_abs_recon_err`` checks the
decomposition against the likelihood's own split per draw.

How it runs: the (draws x sources) pointwise block is computed on the
model's device in the context's dtype, in source chunks, batched over
draws; the Pareto-smoothing sort, the generalized-Pareto tail fit and
the WAIC/LOO sums run on the same device in float64 torch, so a 10^6
source catalog never leaves the card until its per-source results do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.models.context import LFContext
from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, lnlike_exact_bounds_parts, lnlike_single_epoch_parts)
from lumfuncmcmc_tpu_torch.models.likelihood_z import (
    ThetaLayoutZ, lnlike_z_parts)
from lumfuncmcmc_tpu_torch.ops.omega import omega_from_logf
from lumfuncmcmc_tpu_torch.ops.schechter import (
    LN10, log_schechter_z, log_true_lum_func)

# elements of the (rows, m, n) GPD profile tensor one block may hold
GPD_BLOCK_ELEMS = 2 ** 25


# ---------------------------------------------------------------------------
# pointwise ln lambda(x_i) and total intensity Lam(theta)
# ---------------------------------------------------------------------------

def _parts_h(theta, ctx: LFContext, layout: ThetaLayoutH):
    """(lnpart, fullint), each (B,), of the hierarchical data term (no
    hyperprior): the two pieces the reconstruction check needs."""
    _, _, _, _, sch_al, lstar_f, phistar_f = layout.unpack(theta)
    lnpart_f = (ctx.nsrc_f * (math.log(LN10) + LN10 * phistar_f)
                + LN10 * (sch_al[:, None] + 1.0)
                * (ctx.sum_lum_f - ctx.nsrc_f * lstar_f)
                - torch.exp(LN10 * (ctx.lref - lstar_f)) * ctx.sum_pow_lum_f
                + ctx.sum_ln_om_f)
    lnphi_grid = log_true_lum_func(
        ctx.logL_grid, sch_al[:, None, None, None],
        lstar_f[:, :, None, None], phistar_f[:, :, None, None])
    int_f = (torch.exp(lnphi_grid) * ctx.w_fixed).sum(dim=(2, 3))
    return lnpart_f.sum(dim=1), int_f.sum(dim=1)


def make_pointwise_fns(ctx: LFContext, layout, exact_bounds: bool = False,
                       min_comp_frac: float = 0.5, lh: float = 46.0):
    """``(loglam_chunk, parts)`` for the layout's model family.

    ``loglam_chunk(thetas (B, D), lum, z, lnom, logf, om0, fid) -> (B,
    C)``: per-source ``ln lambda`` on a slice of catalog columns;
    ``parts(thetas) -> (lnpart (B,), fullint (B,))``: the likelihood's
    own split, for ``Lam`` and the reconstruction check.
    """
    if isinstance(layout, ThetaLayoutZ):
        def loglam_chunk(theta, lum, z, lnom, logf, om0, fid):
            piv = [p[:, None] for p in layout.unpack(theta)]
            return log_schechter_z(lum, z, piv[6], *piv[:6], layout.z1,
                                   layout.z2, layout.z3) + lnom

        def parts(theta):
            return lnlike_z_parts(theta, ctx, layout)
        return loglam_chunk, parts

    if isinstance(layout, ThetaLayoutH):
        def loglam_chunk(theta, lum, z, lnom, logf, om0, fid):
            _, _, _, _, sch_al, lstar_f, phistar_f = layout.unpack(theta)
            return log_true_lum_func(lum, sch_al[:, None], lstar_f[:, fid],
                                     phistar_f[:, fid]) + lnom

        def parts(theta):
            return _parts_h(theta, ctx, layout)
        return loglam_chunk, parts

    if not isinstance(layout, ThetaLayout):
        raise TypeError(f"unknown layout type {type(layout)!r}")
    if exact_bounds:
        if layout.fix_comp:
            raise ValueError("exact_bounds applies to free completeness "
                             "only")
        lum_floor = float(ctx.lum.min())       # make_lnprob's floor

        def parts(theta):
            return lnlike_exact_bounds_parts(theta, ctx, layout,
                                             min_comp_frac, lum_floor, lh)
    else:
        def parts(theta):
            return lnlike_single_epoch_parts(theta, ctx, layout)

    if layout.fix_comp:
        def loglam_chunk(theta, lum, z, lnom, logf, om0, fid):
            lstar, phistar, sch_al, _, _ = layout.unpack(theta)
            return log_true_lum_func(lum, sch_al[:, None], lstar[:, None],
                                     phistar[:, None]) + lnom
    else:
        def loglam_chunk(theta, lum, z, lnom, logf, om0, fid):
            lstar, phistar, sch_al, logf50, alpha_c = layout.unpack(theta)
            om = omega_from_logf(logf, om0, logf50[:, fid],
                                 alpha_c[:, None], layout.fcmin)
            lnphi = log_true_lum_func(lum, sch_al[:, None], lstar[:, None],
                                      phistar[:, None])
            return lnphi + torch.log(om)
    return loglam_chunk, parts


# ---------------------------------------------------------------------------
# generalized-Pareto tail fit (Zhang & Stephens 2009), vectorized
# ---------------------------------------------------------------------------

def _f64(x):
    return torch.as_tensor(x, dtype=torch.float64)


def gpd_fit_tail(x):
    """Fit GPD(xi, sigma) to exceedances, vectorized over rows.

    ``x``: (C, M) exceedances over the tail threshold, each row sorted
    ascending and non-negative. Returns ``(xi, sigma)``, each (C,), by
    the Zhang & Stephens (2009) weighted-profile estimator with the weak
    prior of Vehtari et al. (2021, app. C) shrinking xi toward 0.5 (the
    JAX function's estimator, in float64 torch on ``x``'s device). Rows
    without information (zero spread, a non-positive quartile) give
    ``xi = inf``, ``sigma = nan``.
    """
    x = _f64(x)
    C, n = x.shape
    m = 30 + int(math.sqrt(n))
    # the (rows, m, n) profile tensor is the memory hot spot
    blk = max(1, GPD_BLOCK_ELEMS // max(n * m, 1))
    if C > blk:
        parts = [gpd_fit_tail(x[i:i + blk]) for i in range(0, C, blk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    xn = x[:, -1]
    xq = x[:, max(int(n / 4 + 0.5) - 1, 0)]
    ok = (xn > 0) & (xq > 0) & (xn > x[:, 0] + 1e-290)
    j = torch.arange(1, m + 1, dtype=torch.float64, device=x.device)
    one = torch.ones_like(xn)
    safe_xn = torch.where(ok, xn, one)
    safe_xq = torch.where(ok, xq, one)
    # theta grid per row; every theta keeps 1 + theta*x > 0
    theta = (-1.0 / safe_xn[:, None]
             + (torch.sqrt(m / (j - 0.5)) - 1.0)[None, :]
             / (3.0 * safe_xq[:, None]))                    # (C, m)
    xi_j = torch.log1p(theta[:, :, None] * x[:, None, :]).mean(dim=2)
    lprof = n * (torch.log(theta / xi_j) - xi_j - 1.0)
    lprof = torch.where(torch.isfinite(lprof), lprof,
                        torch.full_like(lprof, -math.inf))
    w = torch.exp(lprof - lprof.amax(dim=1, keepdim=True))
    w = w / w.sum(dim=1, keepdim=True)
    theta_hat = (w * theta).sum(dim=1)
    xi = torch.log1p(theta_hat[:, None] * x).mean(dim=1)
    sigma = xi / theta_hat
    xi = (n * xi + 5.0) / (n + 10.0)       # weak prior toward 1/2
    return (torch.where(ok, xi, torch.full_like(xi, math.inf)),
            torch.where(ok, sigma, torch.full_like(sigma, math.nan)))


def _gpd_quantiles(p, xi, sigma):
    """GPD inverse CDF, (M,) probabilities against (C,) params -> (M, C)."""
    near0 = xi.abs() < 1e-12
    safe = torch.where(near0, torch.ones_like(xi), xi)
    lp = torch.log1p(-p)[:, None]
    return sigma * torch.where(near0[None, :], -lp,
                               torch.expm1(-safe[None, :] * lp) / safe)


def psis_smooth(loglik):
    """Pareto-smoothed importance weights for LOO.

    ``loglik``: (S, C) pointwise log-likelihood columns. Returns ``(logw,
    k)``: the smoothed, max-normalized log weights (S, C) and the
    per-column Pareto shape (k < 0.7 reliable), float64 on ``loglik``'s
    device. Tied ratios may sort in another order than numpy's; the
    sorted values, and so every result, are the same.
    """
    ll = _f64(loglik)
    S, C = ll.shape
    lr = -ll
    lr = lr - lr.amax(dim=0, keepdim=True)
    M = int(np.ceil(min(0.2 * S, 3.0 * math.sqrt(S))))
    if M < 5:
        return lr, torch.full((C,), math.inf, dtype=torch.float64,
                              device=ll.device)
    srt, order = torch.sort(lr, dim=0)
    cutoff = torch.exp(srt[S - M - 1])                  # (C,)
    tail = srt[S - M:]                                  # (M, C) ascending
    x = torch.exp(tail) - cutoff[None, :]
    xi, sigma = gpd_fit_tail(x.T.contiguous())
    usable = torch.isfinite(xi) & (sigma > 0)
    p = (torch.arange(1, M + 1, dtype=torch.float64, device=ll.device)
         - 0.5) / M
    q = _gpd_quantiles(p, torch.where(usable, xi, torch.zeros_like(xi)),
                       torch.where(usable, sigma, torch.ones_like(sigma)))
    smoothed = torch.log(torch.clamp(q + cutoff[None, :], min=1e-300))
    srt[S - M:] = torch.where(usable[None, :],
                              torch.clamp(smoothed, max=0.0), tail)
    logw = torch.empty_like(lr).scatter_(0, order, srt)
    return logw, torch.where(usable, xi, torch.full_like(xi, math.inf))


def waic_from_loglik(loglik):
    """Per-observation WAIC pieces of an (S, C) block: ``(lppd_i, p_i,
    elpd_i)``, each (C,); the variance with ddof=1."""
    ll = _f64(loglik)
    S = ll.shape[0]
    lppd = torch.logsumexp(ll, dim=0) - math.log(S)
    p = (ll.var(dim=0, correction=1) if S > 1 else torch.zeros_like(lppd))
    return lppd, p, lppd - p


def loo_from_loglik(loglik):
    """Per-observation PSIS-LOO elpd and Pareto k of an (S, C) block."""
    ll = _f64(loglik)
    logw, k = psis_smooth(ll)
    elpd = (torch.logsumexp(ll + logw, dim=0)
            - torch.logsumexp(logw, dim=0))
    return elpd, k


# ---------------------------------------------------------------------------
# the criteria from posterior draws
# ---------------------------------------------------------------------------

def _batched(fn, thetas, batch: int):
    """``fn`` over ``thetas`` in row batches of ``batch``, concatenated
    (``fn`` returns a tensor or a tuple of tensors)."""
    outs = [fn(thetas[i:i + batch]) for i in range(0, thetas.shape[0], batch)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def information_criteria(samples, ctx: LFContext, layout,
                         exact_bounds: bool = False,
                         min_comp_frac: float = 0.5, lh: float = 46.0,
                         ndraws: int = 1000,
                         seed: int = 0, chunk: int = 8192,
                         theta_batch: int = 64,
                         return_pointwise: bool = False):
    """WAIC + PSIS-LOO from posterior draws.

    ``samples``: flat posterior array (n, ndim [+ extra columns,
    ignored]). ``ndraws`` draws are subsampled without replacement by
    ``np.random.default_rng(seed).choice``, the JAX function's call, so
    both packages take the same draws. ``chunk`` sources x
    ``theta_batch`` draws bound the pointwise block's memory.

    Returns the JAX function's dict: ``elpd_waic/p_waic/se_waic``,
    ``elpd_loo/p_loo/se_loo``, ``lppd``, ``k_max``, ``frac_k_gt_07``,
    the count term (``count_lppd``, ``count_p``, ``elpd_waic_total``),
    ``max_abs_recon_err``, ``n_sources``, ``ndraws`` and the per-source
    numpy arrays ``elpd_waic_i``, ``elpd_loo_i``, ``pareto_k`` (and
    ``pointwise_loglik`` (S, N) when asked).
    """
    samples = np.asarray(samples)
    thetas_all = samples[:, :layout.ndim]
    rng = np.random.default_rng(seed)
    if thetas_all.shape[0] > ndraws:
        idx = rng.choice(thetas_all.shape[0], size=ndraws, replace=False)
        thetas_all = thetas_all[idx]
    dev, dt = ctx.lum.device, ctx.lum.dtype
    thetas = torch.as_tensor(thetas_all, dtype=dt, device=dev)
    S = int(thetas.shape[0])
    loglam_chunk, parts = make_pointwise_fns(
        ctx, layout, exact_bounds=exact_bounds, min_comp_frac=min_comp_frac,
        lh=lh)
    with torch.no_grad():
        lnpart_S, fullint_S = (t.double()
                               for t in _batched(parts, thetas, theta_batch))
        lnLam_S = torch.log(fullint_S)

        mask = ctx.src_mask > 0
        cols = [a[mask] for a in (ctx.lum, ctx.zsrc, ctx.ln_om_src,
                                  ctx.logf_src, ctx.omega0_src)]
        fid = ctx.field_id[mask]
        N = int(cols[0].shape[0])
        chunk = max(1, min(chunk, N))
        f64 = dict(dtype=torch.float64, device=dev)
        lppd_i, p_i = torch.empty(N, **f64), torch.empty(N, **f64)
        elpd_loo_i, k_i = torch.empty(N, **f64), torch.empty(N, **f64)
        point_sum_S = torch.zeros(S, **f64)
        pointwise = np.empty((S, N)) if return_pointwise else None
        for lo_c in range(0, N, chunk):
            sl = slice(lo_c, min(lo_c + chunk, N))
            args = [c[sl] for c in cols] + [fid[sl]]
            lam = _batched(lambda t: loglam_chunk(t, *args), thetas,
                           theta_batch)
            ll = lam.double() - lnLam_S[:, None]
            point_sum_S += ll.sum(dim=1)
            if return_pointwise:
                pointwise[:, sl] = ll.cpu().numpy()
            lppd_i[sl], p_i[sl], _ = waic_from_loglik(ll)
            elpd_loo_i[sl], k_i[sl] = loo_from_loglik(ll)

        recon = point_sum_S + N * lnLam_S - fullint_S
        ref = lnpart_S - fullint_S
        scale = torch.clamp(ref.abs(), min=1.0)
        recon_err = float(((recon - ref).abs() / scale).max())
        count_ll = N * lnLam_S - fullint_S - math.lgamma(N + 1)
        count_lppd, count_p, count_elpd = (
            float(x[0]) for x in waic_from_loglik(count_ll[:, None]))

    elpd_waic_i = (lppd_i - p_i).cpu().numpy()
    lppd_i = lppd_i.cpu().numpy()
    p_i = p_i.cpu().numpy()
    elpd_loo_i = elpd_loo_i.cpu().numpy()
    k_i = k_i.cpu().numpy()
    out = {
        "elpd_waic": float(elpd_waic_i.sum()),
        "p_waic": float(p_i.sum()),
        "se_waic": float(np.sqrt(N * np.var(elpd_waic_i, ddof=1))),
        "elpd_loo": float(elpd_loo_i.sum()),
        "p_loo": float((lppd_i - elpd_loo_i).sum()),
        "se_loo": float(np.sqrt(N * np.var(elpd_loo_i, ddof=1))),
        "lppd": float(lppd_i.sum()),
        "k_max": float(k_i.max()),
        "frac_k_gt_07": float(np.mean(k_i > 0.7)),
        "count_lppd": count_lppd,
        "count_p": count_p,
        "elpd_waic_total": float(elpd_waic_i.sum()) + count_elpd,
        "max_abs_recon_err": recon_err,
        "n_sources": N,
        "ndraws": S,
        "elpd_waic_i": elpd_waic_i,
        "elpd_loo_i": elpd_loo_i,
        "pareto_k": k_i,
    }
    if return_pointwise:
        out["pointwise_loglik"] = pointwise
    return out


def stacking_weights(lpd, maxiter: int = 500):
    """Stacking weights for model averaging (Yao et al. 2018).

    ``lpd``: (N, K) pointwise log predictive densities of K models on the
    same N sources. Maximizes ``sum_i log sum_k w_k exp(lpd_ik)`` over
    the simplex (softmax parameterization, BFGS in float64 on the CPU).
    Returns ``(w (K,), info)`` with ``log_score``, ``log_score_single``
    (each model alone), ``pseudo_bma`` and ``converged``.
    """
    from lumfuncmcmc_tpu_torch.models.mapfit import _value_grad, bfgs_minimize
    lpd_t = torch.as_tensor(np.asarray(lpd, dtype=np.float64))
    n, k = lpd_t.shape
    if k < 2:
        raise ValueError("stacking needs at least 2 models")

    def neg_score(a):                      # (B, K) -> (B,)
        logw = torch.log_softmax(a, dim=1)
        return -torch.logsumexp(lpd_t[None] + logw[:, None, :],
                                dim=2).sum(dim=1)

    x, fun, success = bfgs_minimize(neg_score,
                                    torch.zeros((1, k), dtype=torch.float64),
                                    maxiter=maxiter)
    w = torch.softmax(x[0], dim=0).numpy()
    elpd_k = lpd_t.sum(dim=0).numpy()
    bma = np.exp(elpd_k - elpd_k.max())
    fval = float(fun[0])
    _, g = _value_grad(neg_score, x)
    info = {
        "log_score": -fval,
        "log_score_single": elpd_k,
        "pseudo_bma": bma / bma.sum(),
        "converged": bool(success[0]) or bool(
            float(torch.linalg.norm(g)) < 1e-4 * max(1.0, abs(fval))),
    }
    return w, info


def compare_ic(ic_a: dict, ic_b: dict, which: str = "loo"):
    """Paired elpd comparison of two models fitted to the same catalog:
    ``delta = elpd_a - elpd_b`` with the paired standard error ``sqrt(N
    var(d_i))`` (Vehtari et al. 2017, eq. 24), ``z`` and ``preferred``
    ("a"/"b"/"tie" at |z| > 2). ``which``: "loo" or "waic"."""
    key = f"elpd_{which}_i"
    a = np.asarray(ic_a[key], dtype=np.float64)
    b = np.asarray(ic_b[key], dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(
            f"paired comparison needs the same sources: model A has "
            f"{a.shape[0]} pointwise terms, model B {b.shape[0]} — "
            "were the two fits run on the same catalog?")
    d = a - b
    n = d.size
    delta = float(d.sum())
    se = float(np.sqrt(n * np.var(d, ddof=1))) if n > 1 else 0.0
    if se > 0:
        z = delta / se
    elif delta == 0.0:
        z = 0.0          # identical pointwise arrays: a tie, not +inf
    else:
        z = np.inf * np.sign(delta)
    return {
        "delta": delta,
        "se": se,
        "z": float(z),
        "n_sources": int(n),
        "preferred": ("a" if z > 2.0 else "b" if z < -2.0 else "tie"),
    }


def format_ic_report(ic: dict) -> str:
    """Human-readable multi-line summary (logged and written by ``--ic``)."""
    lines = [
        "Predictive information criteria "
        "(%d sources, %d posterior draws)" % (ic["n_sources"],
                                              ic["ndraws"]),
        "  elpd_waic   = %12.3f  (se %.3f, p_waic %.2f)"
        % (ic["elpd_waic"], ic["se_waic"], ic["p_waic"]),
        "  elpd_loo    = %12.3f  (se %.3f, p_loo  %.2f)"
        % (ic["elpd_loo"], ic["se_loo"], ic["p_loo"]),
        "  pareto-k    max %.3f, frac>0.7 %.4f"
        % (ic["k_max"], ic["frac_k_gt_07"]),
        "  count term  lppd %.3f (p %.2f); elpd_waic_total = %.3f"
        % (ic["count_lppd"], ic["count_p"], ic["elpd_waic_total"]),
        "  decomposition check: max rel err %.2e"
        % ic["max_abs_recon_err"],
    ]
    return "\n".join(lines)
