"""1/V_eff binned luminosity-function estimator with bootstrap errors
(port of ``lumfuncmcmc_tpu/models/veff.py``).

Per-source weights are closed form with the cumulative comoving-volume
table (the Fleming factor is constant along z)::

    w_i = 1 / ( Omega_sr * fc(F_i) * [Vc(zmax_i) - Vc(zmin)] )

with zmax_i = min(zmax, z at which L_i hits the field's min flux). The
log-space bin edges are ``linspace(min(L)*1.001, max(L), nbin+1)``, as
in the reference (the faintest source falls below bin 0 and is left
out); the linear version starts at the luminosity of the minimum flux at
zmax. The partial-bin completeness correction (:func:`mult_factor`)
uses fixed-order Gauss-Legendre.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.cosmology import CosmoTable, SQARCSEC_PER_SR
from lumfuncmcmc_tpu_torch.ops.completeness import fleming_from_logf
from lumfuncmcmc_tpu_torch.ops.omega import LOG10_4PI as _LOG10_4PI
from lumfuncmcmc_tpu_torch.ops.quadrature import integrate_gl_unit


def max_z_for_lum(lum, logfmin, cosmo: CosmoTable):
    """Redshift at which log-luminosity ``lum`` dims to log-flux
    ``logfmin``, by inverting the monotone log-dL table."""
    log_dl = 0.5 * (lum - logfmin - _LOG10_4PI)
    return cosmo.z_at_log10_dl_cm(log_dl)


def veff_weights(logf_src, lum, logF50_src, roots_logf_src, omega0_total,
                 zmin, zmax, alpha_c, cosmo: CosmoTable, fcmin=0.1,
                 min_comp_frac=0.5):
    """Per-source 1/V_eff weights. ``omega0_total`` is the summed area of
    all fields in arcsec^2. Sources whose zmax does not exceed zmin get
    weight 0."""
    if min_comp_frac <= 0.001:
        zmax_i = torch.full_like(lum, zmax)
    else:
        zmax_i = torch.clamp(max_z_for_lum(lum, roots_logf_src, cosmo),
                             max=zmax)
    fc = fleming_from_logf(logf_src, logF50_src, alpha_c, fcmin)
    vol = cosmo.comoving_volume_between(zmin, zmax_i)          # Mpc^3/sr
    integ = omega0_total / SQARCSEC_PER_SR * fc * vol
    ok = (zmax_i > zmin) & (integ > 0.0)
    return torch.where(ok, 1.0 / integ, torch.zeros_like(integ))


def _binned_lf_bootstrap_idx(lum, phi, edges, idx, nbins: int,
                             log_bins: bool = True):
    """:func:`binned_lf_bootstrap` given the (nboot, N) resample
    indices."""
    if nbins < 2:
        raise ValueError("binned_lf_bootstrap needs nbins >= 2")
    nboot = idx.shape[0]
    lavg = 0.5 * (edges[:-1] + edges[1:])
    denom = (lavg[1] - lavg[0]) if log_bins else 1.0
    bin_idx = torch.clamp(torch.searchsorted(edges, lum, right=True) - 1,
                          0, nbins - 1)
    inside = ((lum >= edges[0]) & (lum < edges[-1])).to(phi.dtype)
    contrib = phi * inside
    lfbinorig = torch.zeros(nbins, dtype=phi.dtype, device=phi.device
                            ).index_add_(0, bin_idx, contrib) / denom
    lfbin = torch.zeros((nboot, nbins), dtype=phi.dtype, device=phi.device
                        ).scatter_add_(1, bin_idx[idx], contrib[idx]) / denom
    binavg = lfbin.mean(dim=0)
    var = ((lfbin - binavg) ** 2).sum(dim=0) / (nboot - 1)
    # floor zero/negative variances at the smallest positive value
    pos = torch.where(var > 0.0, var, torch.full_like(var, math.inf))
    var = torch.where(var <= 0.0, pos.min(), var)
    return lavg, lfbinorig, var


def binned_lf_bootstrap(generator: torch.Generator, lum, phi, edges,
                        nboot: int, nbins: int, log_bins: bool = True):
    """Binned LF + bootstrap variance.

    Returns (Lavg, lfbinorig, var): bin centers, sum(phi)/dL per bin
    (the linear version leaves the dL division out), and the ddof=1
    variance over ``nboot`` resamples drawn from ``generator``, with the
    reference's positive floor for zero entries.
    """
    n = lum.shape[0]
    idx = torch.randint(0, n, (nboot, n), generator=generator,
                        device=lum.device)
    return _binned_lf_bootstrap_idx(lum, phi, edges, idx, nbins, log_bins)


def log_bin_edges(lum, nbins: int):
    """Reference log-space edges."""
    return torch.linspace(float(lum.min()) * 1.001, float(lum.max()),
                          nbins + 1, dtype=lum.dtype, device=lum.device)


def _min_lum_at(z, logfmin, cosmo: CosmoTable):
    """log10 luminosity of log-flux ``logfmin`` at redshift ``z``."""
    return logfmin + _LOG10_4PI + 2.0 * cosmo.log10_dl_cm_at(z)


def _on_table(v, cosmo: CosmoTable):
    return torch.as_tensor(v, dtype=cosmo.zgrid.dtype,
                           device=cosmo.zgrid.device)


def linear_bin_edges(lum_linear, logfmin, zmax, cosmo: CosmoTable,
                     nbins: int):
    """Reference linear-space edges: from the luminosity of the minimum
    flux at zmax up to max(L). ``lum_linear`` is linear luminosity
    [erg/s]."""
    lmin = 10.0 ** float(_min_lum_at(_on_table(zmax, cosmo), logfmin, cosmo))
    return torch.linspace(lmin, float(lum_linear.max()), nbins + 1,
                          dtype=lum_linear.dtype, device=lum_linear.device)


def mult_factor(lum0, lum1, logfmin, zmin, zmax, cosmo: CosmoTable,
                n_nodes: int = 128):
    """Partial-bin completeness correction: the ratio of the full (z x L)
    bin rectangle to its part above the minimum-luminosity curve
    Lmin(z); inf for a bin wholly below the curve, 1 for one wholly
    above."""
    lum0, lum1, zmin, zmax = (_on_table(v, cosmo)
                              for v in (lum0, lum1, zmin, zmax))

    def covered_width(zq):
        return torch.minimum(torch.clamp(
            lum1 - _min_lum_at(zq, logfmin, cosmo), min=0.0), lum1 - lum0)

    denom = integrate_gl_unit(covered_width, n_nodes, zmin, zmax)
    full = (zmax - zmin) * (lum1 - lum0)
    out = torch.where(_min_lum_at(zmax, logfmin, cosmo) <= lum0,
                      torch.ones_like(full), full / denom)
    return torch.where(_min_lum_at(zmin, logfmin, cosmo) >= lum1,
                       torch.full_like(full, math.inf), out)


def apply_partial_bin_correction(edges, lfbinorig, var, logfmin, zmin,
                                 zmax, cosmo: CosmoTable):
    """Scale partially covered faint bins by :func:`mult_factor`: walk
    up from the faintest bin until the factor is 1. Takes and returns
    host arrays (float64 numpy)."""
    edges = np.asarray(edges, dtype=np.float64)
    lf = np.array(lfbinorig, dtype=np.float64)
    vr = np.array(var, dtype=np.float64)
    for j in range(len(lf)):
        m = float(mult_factor(edges[j], edges[j + 1], logfmin, zmin, zmax,
                              cosmo))
        if abs(m - 1.0) < 1.0e-8:
            break
        lf[j] *= m
        vr[j] *= m * m
    return lf, vr


def equal_count_z_bins(z, numbins: int):
    """Equal-count bin index per object (host-side numpy)."""
    z = np.asarray(z)
    idx = np.linspace(0, numbins, z.size, endpoint=False).astype(int)
    return idx[z.argsort().argsort()]
