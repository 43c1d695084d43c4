"""Host-side matplotlib plots (port of ``corner_plot``,
``triangle_plot_single``, ``triangle_plot_z`` and the ``vmax`` plots
``plot_schechter``, ``plot_z_evolution`` and ``plot_param_space`` from
``lumfuncmcmc_tpu/utils/plotting.py``).

matplotlib is imported inside the plotting functions only: a machine
without it can still run every other part of the package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.ops.omega import LOG10_4PI as _LOG10_4PI


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.rcParams.update({
        "xtick.direction": "in", "ytick.direction": "in",
        "xtick.top": True, "ytick.right": True,
    })
    return plt


def _quantile_title(x, label):
    q16, q50, q84 = np.percentile(x, [16, 50, 84])
    return (f"{label} = ${q50:.2f}_{{-{q50 - q16:.2f}}}"
            f"^{{+{q84 - q50:.2f}}}$")


def corner_plot(samples, labels, bins=30, range_frac=0.95, fig=None):
    """Minimal triangle plot: histograms on the diagonal (with
    16/50/84% titles and quantile lines), 2-D histograms + contours
    below the diagonal."""
    plt = _pyplot()
    samples = np.asarray(samples)
    ndim = samples.shape[1]
    lo = np.percentile(samples, 100 * (1 - range_frac) / 2, axis=0)
    hi = np.percentile(samples, 100 * (1 + range_frac) / 2, axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    lo, hi = lo - 0.02 * span, hi + 0.02 * span

    size = max(2.0 * ndim, 6.0)
    if fig is None:
        fig = plt.figure(figsize=(size, size))
    axes = fig.subplots(ndim, ndim, squeeze=False)
    fs = 11 + int(round(0.75 * ndim))
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i][j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(samples[:, i], bins=bins, range=(lo[i], hi[i]),
                        histtype="step", color="k")
                for q in np.percentile(samples[:, i], [16, 50, 84]):
                    ax.axvline(q, color="k", ls="dashed", lw=0.8)
                ax.set_title(_quantile_title(samples[:, i], labels[i]),
                             fontsize=fs - 2)
                ax.set_yticks([])
            else:
                h, xe, ye = np.histogram2d(
                    samples[:, j], samples[:, i], bins=bins,
                    range=[(lo[j], hi[j]), (lo[i], hi[i])])
                ax.pcolormesh(xe, ye, h.T, cmap="Greys", rasterized=True)
                hs = np.sort(h.ravel())[::-1]
                cdf = np.cumsum(hs) / max(hs.sum(), 1)
                levels = sorted({float(hs[np.searchsorted(cdf, f)])
                                 for f in (0.39, 0.86)
                                 if np.searchsorted(cdf, f) < hs.size})
                if levels:
                    xc = 0.5 * (xe[:-1] + xe[1:])
                    yc = 0.5 * (ye[:-1] + ye[1:])
                    try:
                        ax.contour(xc, yc, h.T, levels=levels,
                                   colors="k", linewidths=0.8)
                    except ValueError:
                        pass  # degenerate histogram (e.g. single cell)
            ax.set_xlim(lo[j], hi[j])
            if i != j:
                ax.set_ylim(lo[i], hi[i])
            if i == ndim - 1:
                ax.set_xlabel(labels[j], fontsize=fs)
                ax.tick_params(labelsize=fs - 4)
                ax.tick_params(axis="x", rotation=45)
            else:
                ax.set_xticklabels([])
            if j == 0 and i != 0:
                ax.set_ylabel(labels[i], fontsize=fs)
                ax.tick_params(labelsize=fs - 4)
            else:
                ax.set_yticklabels([])
    fig.subplots_adjust(hspace=0.06, wspace=0.06)
    return fig


def add_lumfunc_axes(ax):
    """Axis styling of the LF inset."""
    ax.set_yscale("log")
    ax.set_xlabel(r"$\log$ L (erg s$^{-1}$)")
    ax.set_ylabel(r"$\phi_{\rm{true}}$ (Mpc$^{-3}$ dex$^{-1}$)")
    ax.minorticks_on()


def _inset_axes(fig, ndim, left):
    """The LF inset in the corner plot's empty upper right."""
    return fig.add_axes(
        [left - 0.008 * (ndim - 4), 0.78 - 0.001 * (ndim - 4),
         0.48 + 0.008 * (ndim - 4), 0.19 + 0.001 * (ndim - 4)]
        if ndim >= 4 else [0.67, 0.75, 0.32, 0.23])


def triangle_plot_single(model, outname, lnprobcut=7.5, imgtype="png",
                         rndsamples=200):
    """Corner plot with the LF inset: 200 posterior LF draws, the median
    LF, and an x-window starting at the completeness floor."""
    from lumfuncmcmc_tpu_torch.models.model import (
        posterior_lfs, select_samples)
    from lumfuncmcmc_tpu_torch.ops.completeness import fleming_root_logf_np

    plt = _pyplot()
    nsamples = select_samples(model.samples, lnprobcut)
    model.log.info("Shape of nsamples (with a lnprobcut applied)")
    model.log.info(str(nsamples.shape))
    fig = corner_plot(nsamples[:, :-1], model.get_param_names())

    ax1 = _inset_axes(fig, nsamples.shape[1] - 1, 0.50)
    add_lumfunc_axes(ax1)

    lum = model.lum
    indsort = np.argsort(lum)
    # medianLF / median_flim / median_alpha and the V_eff overlay come
    # from one routine so they cannot diverge
    model.set_median_fit(rndsamples=rndsamples, lnprobcut=lnprobcut)
    rng = np.random.default_rng(model.cfg.seed + 3)
    idx = rng.integers(0, nsamples.shape[0], rndsamples)
    draws = nsamples[idx, :-1]
    lfs = posterior_lfs(model, draws)
    for mod in lfs:
        ax1.plot(lum[indsort], mod[indsort], color="r", linestyle="solid",
                 alpha=0.1)
    ax1.plot(lum[indsort], model.medianLF[indsort], color="dimgray",
             linestyle="solid")

    # axis limits from the completeness floor
    logF50 = np.log10(model.median_flim) - 17.0
    if model.cfg.min_comp_frac > 0.001:
        roots = fleming_root_logf_np(logF50, model.median_alpha,
                                     model.cfg.min_comp_frac,
                                     model.cfg.fcmin)
    else:
        roots = logF50 - 2.0
    zmin_dl = float(model.ctx.cosmo.log10_dl_cm_at(
        torch.tensor(model.zmin, dtype=model.dtype, device=model.device)))
    xmin = float(np.max(roots)) + _LOG10_4PI + 2.0 * zmin_dl
    xmax = min(lum.max(), np.median(draws[:, 0]) + 1.0)
    ax1.set_xlim(left=xmin, right=xmax)
    cond = (lum >= xmin) & (lum <= xmax)
    if cond.any():
        ax1.set_ylim(bottom=np.percentile(model.medianLF[cond], 0),
                     top=np.percentile(model.medianLF[cond], 100))
    fig.savefig(f"{outname}.{imgtype}", dpi=200)
    plt.close(fig)


def triangle_plot_z(model, outname, lnprobcut=7.5, imgtype="png",
                    zlen=100, Llen=100):
    """z-variant corner plot with the LF(z, L) pcolormesh inset."""
    import warnings

    from lumfuncmcmc_tpu_torch.models.model import select_samples

    plt = _pyplot()
    nsamples = select_samples(model.samples, lnprobcut)
    fig = corner_plot(nsamples[:, :-1], model.get_param_names())
    ax1 = _inset_axes(fig, nsamples.shape[1] - 1, 0.44)
    add_lumfunc_axes(ax1)

    model.set_median_fit(lnprobcut=lnprobcut, zlen=zlen, Llen=Llen)
    LL, zzout = np.meshgrid(model.Lout, model.zout)
    # reference semantics: the y coordinates are the LF values
    # (non-monotonic by construction) coloured by redshift; matplotlib
    # warns about the cell-centre interpretation, which is intended
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*cell centers.*")
        im = ax1.pcolormesh(LL, model.medianLF, zzout, shading="auto",
                            cmap="viridis")
    med = np.percentile(nsamples[:, :3], 50.0, axis=0)
    xmax = min(np.max(med) + 0.5, model.Lout.max())
    cond = model.Lout <= xmax
    ax1.set_ylim(bottom=max(np.percentile(model.medianLF[:, cond], 1),
                            3.1e-5 * model.medianLF.max()))
    ax1.set_xlim(right=xmax)
    fig.colorbar(im, ax=ax1, label="Redshift", fraction=0.05, pad=0.02)
    fig.savefig(f"{outname}.{imgtype}", dpi=200)
    plt.close(fig)


def _amp_and_label(pars, lavg, log, integ, prefix=""):
    """(plot ratio, legend label) of a Schechter fit: the linear forms
    are drawn per bin width in L/L*."""
    if log:
        return 1.0, (r"%s$\alpha=%.*f$, amp$=%.2f$, $\log L_*=%.2f$"
                     % (prefix, 2 if prefix else 3, pars["al"],
                        pars["integ" if integ else "phistar"],
                        pars["Lstar"]))
    ratio = pars["Lstar"] / (lavg[1] - lavg[0])
    return ratio, (r"%s$\alpha=%.*f$, amp$=%.1e$, $L_*=%.1e$"
                   % (prefix, 2 if prefix else 3, pars["al"],
                      pars["integ" if integ else "phistar"] * ratio,
                      pars["Lstar"]))


def _schechter_axes(plt, log):
    fig, ax = plt.subplots()
    if not log:
        ax.set_xscale("log")
    ax.set_yscale("log")
    return fig, ax


def _save_schechter(plt, fig, ax, img_dir, stem, log, integ, legend_kw):
    if log:
        ax.set_xlabel(r"$\log$ L (erg s$^{-1}$)")
        ax.set_ylabel(r"$\phi_{\rm{true}}$ (Number Mpc$^{-3}$ dex$^{-1}$)")
    else:
        ax.set_xlabel(r"L (erg s$^{-1}$)")
        ax.set_ylabel(r"$dn/d({\rm{L/L_*}})$ (Number Mpc$^{-3}$)")
    ax.legend(loc="best", **legend_kw)
    ax.minorticks_on()
    sub = "Log" if log else "Lin"
    os.makedirs(os.path.join(img_dir, sub), exist_ok=True)
    suffix = ("_log" if log else "") + ("_integ" if integ else "")
    fn = os.path.join(img_dir, sub, f"{stem}{suffix}.png")
    fig.savefig(fn, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return fn


def _band(fit, lavg):
    """The 3-sigma delta-method band, or None where the covariance is
    not usable."""
    dely = fit.eval_uncertainty(lavg, sigma=3)
    return dely if np.all(np.isfinite(dely)) else None


def plot_schechter(Lavg, lfbinorig, var, fit, name, img_dir="ImageFiles",
                   log=False, integ=False):
    """Best-fit Schechter over the binned V_eff LF with a 3-sigma
    band."""
    plt = _pyplot()
    fig, ax = _schechter_axes(plt, log)
    best = fit.best_fit(Lavg)
    ratio, label = _amp_and_label(fit.params, Lavg, log, integ)
    ax.plot(Lavg, best * ratio, "r-", label="Fit: " + label)
    ax.errorbar(Lavg, lfbinorig * ratio, yerr=np.sqrt(var) * ratio,
                fmt="b^", label="Measured LF")
    dely = _band(fit, Lavg)
    if dely is not None:
        ax.fill_between(Lavg, ratio * (best - dely), ratio * (best + dely),
                        color="r", alpha=0.2,
                        label=r"$3 \sigma$ Uncertainty Band")
    return _save_schechter(plt, fig, ax, img_dir, os.path.splitext(name)[0],
                           log, integ, {})


_MARKERS = ["o", "^", "*", "s", "+", "v", "<", ">"]


def plot_z_evolution(results, name, img_dir="ImageFiles", log=True,
                     integ=False):
    """Overlay per-z-bin binned LFs and their Schechter fits on one
    figure. ``results``: list of dicts with keys Lavg, lfbinorig, var,
    fit, zlabel."""
    plt = _pyplot()
    fig, ax = _schechter_axes(plt, log)
    for i, r in enumerate(results):
        best = r["fit"].best_fit(r["Lavg"])
        ratio, label = _amp_and_label(r["fit"].params, r["Lavg"], log,
                                      integ, prefix=r["zlabel"] + ": ")
        eb = ax.errorbar(r["Lavg"], r["lfbinorig"] * ratio,
                         yerr=np.sqrt(r["var"]) * ratio,
                         marker=_MARKERS[i % len(_MARKERS)],
                         linestyle="none", label="")
        color = eb.lines[0].get_color()
        ax.plot(r["Lavg"], best * ratio, color=color, label=label)
        dely = _band(r["fit"], r["Lavg"])
        if dely is not None:
            ax.fill_between(r["Lavg"], ratio * (best - dely),
                            ratio * (best + dely), color=color,
                            alpha=0.2, label="")
    return _save_schechter(plt, fig, ax, img_dir,
                           os.path.splitext(name)[0] + "_zevol", log, integ,
                           {"fontsize": "x-small"})


def plot_param_space(mcf, al, ls, mcfmc=None, almc=None, lsmc=None,
                     ln="OIII", lp=r"[OIII] $\lambda 5007$",
                     img_dir="ImageFiles", extratext=""):
    """Scatter of (alpha, L*) colored by min completeness fraction."""
    plt = _pyplot()
    fig = plt.figure()
    # one shared normalization: independent autoscaling would map the
    # same completeness fraction to different colors in the two sets
    allc = (np.concatenate([np.asarray(mcf), np.asarray(mcfmc)])
            if mcfmc is not None else np.asarray(mcf))
    vmin, vmax = float(np.min(allc)), float(np.max(allc))
    sc = plt.scatter(al, ls, c=mcf, s=12, cmap="viridis",
                     vmin=vmin, vmax=vmax)
    if almc is not None:
        sc = plt.scatter(almc, lsmc, c=mcfmc, s=40, marker="*",
                         cmap="viridis", vmin=vmin, vmax=vmax)
    plt.xlabel(r"%s $\alpha$" % lp)
    plt.ylabel(r"%s $\mathcal{L}_*$" % lp)
    plt.colorbar(sc, label="Min Completeness Fraction")
    os.makedirs(img_dir, exist_ok=True)
    fn = os.path.join(img_dir, f"al_ls_mcf_space_mcmc_{ln}{extratext}.png")
    plt.savefig(fn, bbox_inches="tight", dpi=300)
    plt.close(fig)
    return fn
