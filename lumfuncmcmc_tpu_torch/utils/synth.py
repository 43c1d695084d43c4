"""Synthetic emission-line catalogs from a known Schechter process (port
of ``lumfuncmcmc_tpu/utils/synth.py``, numpy, unchanged in behaviour:
the same seed draws the same catalog in both packages).

The intensity is ``phi(logL | theta_true) * dV/dz(z) * Omega(logL, z)``,
the exact inhomogeneous-Poisson process the likelihood models.
"""

from __future__ import annotations

import numpy as np

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.cosmology import (
    build_cosmo_arrays, SQARCSEC_PER_SR)
from lumfuncmcmc_tpu_torch.ops.completeness import (
    fleming_from_logf_np, fleming_root_logf_np)
from lumfuncmcmc_tpu_torch.ops.omega import LOG10_4PI as _LOG10_4PI



def make_catalog(cfg: LFConfig, zmin=1.16, zmax=1.90,
                 n_target=None, seed=0, ngrid=512,
                 lum_err_dex=0.0):
    """Draw a catalog; returns dict with z, flux (1e-17 cgs), flux_e,
    field_id, and the true (logL) values.

    ``n_target``: approximate total sources wanted; the per-field Poisson
    intensity is rescaled to hit it (amplitude change only — shape of the
    process is untouched). None keeps the physical phi* normalization.

    ``lum_err_dex``: Gaussian measurement scatter applied to the
    OBSERVED log-luminosities (and hence fluxes); ``true_lum`` keeps
    the noiseless draws. The default 0 produces exact fluxes — the
    ``flux_e`` column is then a nominal reported-error column for the
    delta-method propagation path, like the reference catalogs' error
    columns, not actual scatter.
    """
    rng = np.random.default_rng(seed)
    nfields = len(cfg.Flim)
    tabs = build_cosmo_arrays(zmax=1.05 * zmax + 0.1)
    zg = tabs["zgrid"]
    logdl_tab = tabs["log10_dl_cm"]
    dvdz_tab = tabs["dvdz_sr"]

    zc = np.linspace(zmin, zmax, ngrid)
    lc = np.linspace(cfg.Lc + 0.5, cfg.Lh - 1.0, ngrid)
    dz = zc[1] - zc[0]
    dl = lc[1] - lc[0]
    logdl = np.interp(zc, zg, logdl_tab)
    dvdz = np.interp(zc, zg, dvdz_tab)

    # true Schechter phi(logL)
    x = lc - cfg.Lstar
    phi = (np.log(10.0) * 10.0**cfg.phistar
           * 10.0 ** (x * (cfg.sch_al + 1.0)) * np.exp(-(10.0**x)))

    out_z, out_flux, out_fid, out_lum = [], [], [], []
    intens_fields = []
    for f in range(nfields):
        logF50 = np.log10(cfg.Flim[f]) - 17.0
        logf_grid = lc[:, None] - _LOG10_4PI - 2.0 * logdl[None, :]
        om = (cfg.Omega_0[f] / SQARCSEC_PER_SR
              * fleming_from_logf_np(logf_grid, logF50, cfg.alpha,
                                     cfg.fcmin))
        intens = phi[:, None] * dvdz[None, :] * om * dz * dl
        intens_fields.append(intens)
    total = sum(i.sum() for i in intens_fields)
    scale = 1.0 if n_target is None else n_target / total

    for f in range(nfields):
        intens = intens_fields[f] * scale
        lam = intens.sum()
        n = rng.poisson(lam)
        p = (intens / lam).ravel()
        idx = rng.choice(p.size, size=n, p=p)
        iL, iz = np.unravel_index(idx, intens.shape)
        lum = lc[iL] + rng.uniform(-0.5, 0.5, n) * dl
        z = zc[iz] + rng.uniform(-0.5, 0.5, n) * dz
        out_lum.append(lum)
        out_z.append(z)
        obs_lum = lum
        if lum_err_dex:
            obs_lum = lum + rng.normal(0.0, lum_err_dex, n)
        logdl_src = np.interp(z, zg, logdl_tab)
        logf = obs_lum - _LOG10_4PI - 2.0 * logdl_src
        out_flux.append(10.0 ** (logf + 17.0))   # 1e-17 cgs units
        out_fid.append(np.full(n, f, dtype=np.int32))

    flux = np.concatenate(out_flux)
    flux_e = 0.1 * flux  # nominal 10% flux errors
    # n_target rescales the process AMPLITUDE: the catalog is drawn from
    # a Schechter with log-amplitude phistar + log10(scale). Report that
    # effective truth — comparing posteriors against the unscaled
    # phistar mislabels them by log10(scale) (caught by the frequentist
    # coverage check, examples/coverage_check.py).
    return {
        "z": np.concatenate(out_z),
        "flux": flux,
        "flux_e": flux_e,
        "field_id": np.concatenate(out_fid),
        "true_lum": np.concatenate(out_lum),
        "theta_true": {"Lstar": cfg.Lstar,
                       "phistar": cfg.phistar + float(np.log10(scale)),
                       "sch_al": cfg.sch_al},
    }


def apply_completeness_cut(cat, cfg):
    """Drop sources below each field's min-completeness flux root,
    mirroring the reference's catalog ingest (``run_lumfuncmcmc.py:174-186``).
    """
    if cfg.min_comp_frac <= 0.001:
        return cat
    logF50 = np.log10(np.asarray(cfg.Flim)) - 17.0
    roots = fleming_root_logf_np(logF50, cfg.alpha, cfg.min_comp_frac,
                                 cfg.fcmin)
    keep = np.log10(cat["flux"] * 1e-17) > roots[cat["field_id"]]
    return {k: (v[keep] if isinstance(v, np.ndarray) and v.shape[:1] ==
                keep.shape else v) for k, v in cat.items()}
