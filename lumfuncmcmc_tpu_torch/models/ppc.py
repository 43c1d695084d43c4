"""Posterior predictive checks (port of ``lumfuncmcmc_tpu/models/ppc.py``).

For any luminosity bin B the Poisson point-process model predicts the
rate

    N_pred(B | theta) = sum_f integral_B phi(L|theta) Omega_f dV/dz dz,

evaluated by re-binning the frozen quadrature grid: each node carries
``logL[f,i,j]`` and its weight, and a segment sum over the bin index of
every node (``index_add_`` on the context's device) accumulates them.
Posterior draws with Poisson scatter give the predictive count
distribution per bin, compared with the observed histogram by
two-sided predictive p-values. The draws and the scatter use the JAX
function's numpy generator calls, so both packages draw the same.
"""

from __future__ import annotations

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.models.context import LFContext
from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH
from lumfuncmcmc_tpu_torch.models.likelihood_z import ThetaLayoutZ
from lumfuncmcmc_tpu_torch.ops.omega import omega_from_logf
from lumfuncmcmc_tpu_torch.ops.schechter import (
    log_schechter_z, log_true_lum_func)

_CELL = (slice(None), None, None, None)       # (B,) -> (B, 1, 1, 1)
THETA_BATCH = 50      # draws a rate evaluation takes at once


def _rate_contrib(theta, ctx: LFContext, layout):
    """Per-node expected-count contribution, (B, D) -> (B, F, nz, nl)."""
    if isinstance(layout, ThetaLayoutZ):
        piv = [p[_CELL] for p in layout.unpack(theta)]
        lnphi = log_schechter_z(ctx.logL_grid, ctx.zarr[:, None, :], piv[6],
                                *piv[:6], layout.z1, layout.z2, layout.z3)
        return torch.exp(lnphi) * ctx.w_fixed
    if isinstance(layout, ThetaLayoutH):
        _, _, _, _, sch_al, lstar_f, phistar_f = layout.unpack(theta)
        lnphi = log_true_lum_func(ctx.logL_grid, sch_al[_CELL],
                                  lstar_f[:, :, None, None],
                                  phistar_f[:, :, None, None])
        return torch.exp(lnphi) * ctx.w_fixed
    lstar, phistar, sch_al, logf50, alpha_c = layout.unpack(theta)
    lnphi = log_true_lum_func(ctx.logL_grid, sch_al[_CELL], lstar[_CELL],
                              phistar[_CELL])
    if layout.fix_comp:
        return torch.exp(lnphi) * ctx.w_fixed
    om = omega_from_logf(ctx.logf_grid, ctx.omega0_f[:, None, None],
                         logf50[:, :, None, None], alpha_c[_CELL],
                         layout.fcmin)
    return torch.exp(lnphi) * om * ctx.w_open


def predicted_counts(theta, ctx: LFContext, layout, edges):
    """Expected counts per luminosity bin, (B, D) thetas -> (B, nbins):
    each grid node's contribution summed into its bin (``index_add_``),
    nodes outside ``[edges[0], edges[-1])`` left out."""
    contrib = _rate_contrib(theta, ctx, layout)
    edges = torch.as_tensor(edges, dtype=contrib.dtype, device=contrib.device)
    nbins = edges.shape[0] - 1
    grid = ctx.logL_grid.reshape(-1)
    idx = torch.clamp(torch.searchsorted(edges, grid, right=True) - 1, 0,
                      nbins - 1)
    inside = ((grid >= edges[0]) & (grid < edges[-1])).to(contrib.dtype)
    vals = contrib.reshape(contrib.shape[0], -1) * inside
    out = torch.zeros((contrib.shape[0], nbins), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(1, idx, vals)


def posterior_predictive_check(samples, ctx: LFContext, layout,
                               nbins: int = 20, ndraws: int = 200,
                               seed: int = 0):
    """Bin-wise posterior predictive check.

    ``samples``: flat posterior array (n, ndim [+ extra columns,
    ignored]). The rates are computed on the context's device,
    ``THETA_BATCH`` draws at a time. Returns bin ``centers`` and
    ``edges``, ``observed`` counts, ``rate_mean``, the predictive
    16/50/84 bands with Poisson scatter, two-sided ``pvalue`` per bin,
    ``total_observed`` and ``total_predicted``.
    """
    rng = np.random.default_rng(seed)
    mask = (ctx.src_mask > 0).cpu().numpy()
    lum = ctx.lum.double().cpu().numpy()[mask]
    edges = np.linspace(lum.min() - 1e-9, lum.max() + 1e-9, nbins + 1)
    observed, _ = np.histogram(lum, bins=edges)

    idx = rng.integers(0, samples.shape[0], ndraws)
    thetas = torch.as_tensor(np.asarray(samples)[idx, :layout.ndim],
                             dtype=ctx.lum.dtype, device=ctx.lum.device)
    with torch.no_grad():
        rates = torch.cat([
            predicted_counts(thetas[i:i + THETA_BATCH], ctx, layout, edges)
            for i in range(0, ndraws, THETA_BATCH)])
    rates = rates.double().cpu().numpy()
    draws = rng.poisson(np.maximum(rates, 0.0))
    lo, med, hi = np.percentile(draws, [16, 50, 84], axis=0)
    # no continuity correction: both tails include P(draws == obs), so
    # low-count bins get conservative p-values
    p_hi = (draws >= observed[None, :]).mean(axis=0)
    p_lo = (draws <= observed[None, :]).mean(axis=0)
    pval = np.minimum(1.0, 2.0 * np.minimum(p_hi, p_lo))
    return {
        "centers": 0.5 * (edges[:-1] + edges[1:]),
        "edges": edges,
        "observed": observed,
        "rate_mean": rates.mean(axis=0),
        "pred_p16": lo, "pred_p50": med, "pred_p84": hi,
        "pvalue": pval,
        "total_observed": int(observed.sum()),
        "total_predicted": float(rates.sum(axis=1).mean()),
    }


def plot_ppc(ppc: dict, outname: str):
    """Observed counts against the posterior predictive band."""
    from lumfuncmcmc_tpu_torch.utils.plotting import _pyplot
    plt = _pyplot()
    fig, (ax, axp) = plt.subplots(
        2, 1, sharex=True, figsize=(7, 6),
        gridspec_kw={"height_ratios": [3, 1]})
    ax.fill_between(ppc["centers"], ppc["pred_p16"], ppc["pred_p84"],
                    alpha=0.3, color="C0", label="posterior predictive 68%")
    ax.plot(ppc["centers"], ppc["pred_p50"], color="C0", lw=1)
    ax.plot(ppc["centers"], ppc["observed"], "k.", label="observed")
    ax.set_yscale("log")
    ax.set_ylabel("counts per bin")
    ax.legend(loc="best")
    ax.set_title(f"N_obs={ppc['total_observed']}  "
                 f"E[N_pred]={ppc['total_predicted']:.1f}")
    axp.plot(ppc["centers"], ppc["pvalue"], "k.-", lw=0.8)
    axp.axhline(0.05, color="r", ls=":", lw=0.8)
    axp.set_ylim(0, 1.05)
    axp.set_xlabel(r"$\log$ L (erg s$^{-1}$)")
    axp.set_ylabel("pred. p-value")
    fig.savefig(outname, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return outname
