"""Frozen likelihood context: the "model build" step (port of
``lumfuncmcmc_tpu/models/context.py``).

:func:`build_context` runs in float64 numpy on the host, line for line
as in the JAX package, and casts once at the end to the run's device and
dtype. :func:`context_from_arrays` builds the same :class:`LFContext`
from another context's fields given as numpy arrays — the model has no
weights, so this frozen grid-and-catalog state is what tests carry
between the two packages to compute on identical grids.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.cosmology import (
    CosmoTable, SQARCSEC_PER_SR, build_cosmo_arrays,
    cosmo_table_from_arrays)
from lumfuncmcmc_tpu_torch.ops.completeness import (
    fleming_from_logf_np, fleming_root_logf_np)
from lumfuncmcmc_tpu_torch.ops.omega import (
    LOG10_4PI as _LOG10_4PI, logflux_from_loglum, loglum_from_logflux)


@dataclass(frozen=True)
class LFData:
    """Concatenated multi-field catalog arrays."""

    z: torch.Tensor                  # (N,) redshifts
    lum: torch.Tensor                # (N,) log10 L [erg/s]
    lum_e: Optional[torch.Tensor]    # (N,) log10 L errors (or None)
    flux: torch.Tensor               # (N,) flux [erg/cm^2/s]
    flux_e: Optional[torch.Tensor]   # (N,) flux errors (or None)
    field_id: torch.Tensor           # (N,) int64 field index per source


@dataclass(frozen=True)
class LFContext:
    """Frozen likelihood grids + caches, all on the run's device.
    Fields and their meaning as in the JAX ``LFContext``."""

    # --- catalog-derived scalars for the collapsed ln-term ---
    nsrc: torch.Tensor
    sum_lum: torch.Tensor
    lref: torch.Tensor            # max(lum) — scaling anchor
    sum_pow_lum: torch.Tensor     # sum of 10^(lum - lref)
    sum_ln_om: torch.Tensor       # sum of ln Omega at build-time params
    # --- same scalars per field ---
    nsrc_f: torch.Tensor
    sum_lum_f: torch.Tensor
    sum_pow_lum_f: torch.Tensor
    sum_ln_om_f: torch.Tensor
    # --- per-source arrays ---
    lum: torch.Tensor
    zsrc: torch.Tensor
    logf_src: torch.Tensor
    omega0_src: torch.Tensor      # (N,) per-source survey area (arcsec^2)
    ln_om_src: torch.Tensor
    field_id: torch.Tensor        # (N,) int64
    src_mask: torch.Tensor
    # --- frozen quadrature grids ---
    zarr: torch.Tensor            # (F, S)
    log_dl_zarr: torch.Tensor     # (F, S)
    volume_part: torch.Tensor     # (F, S)
    logL_grid: torch.Tensor       # (F, S, S); i = L node, j = z node
    w_fixed: torch.Tensor         # (F, S, S) weights incl. frozen Omega
    w_open: torch.Tensor          # (F, S, S) weights excl. Omega
    logf_grid: torch.Tensor       # (F, S, S)
    # --- scalars ---
    z_lo: torch.Tensor
    z_hi: torch.Tensor
    # --- per-field parameters ---
    omega0_f: torch.Tensor
    logF50_f: torch.Tensor
    alpha_c: torch.Tensor
    roots_logf: torch.Tensor
    # --- cosmology ---
    cosmo: CosmoTable


CTX_FIELDS = tuple(f.name for f in fields(LFContext))


def context_from_arrays(arrays: dict, device, dtype) -> LFContext:
    """:class:`LFContext` from numpy arrays keyed by field name.

    ``arrays["cosmo"]`` maps the :class:`CosmoTable` field names to
    arrays. ``field_id`` becomes int64; every other field ``dtype``.
    """
    vals = {}
    for name in CTX_FIELDS:
        if name == "cosmo":
            vals[name] = cosmo_table_from_arrays(arrays["cosmo"], device,
                                                 dtype)
        elif name == "field_id":
            vals[name] = torch.tensor(np.asarray(arrays[name]),
                                      dtype=torch.int64, device=device)
        else:
            vals[name] = torch.tensor(np.asarray(arrays[name]),
                                      dtype=dtype, device=device)
    return LFContext(**vals)


def propagate_flux_to_lum(flux, flux_e, log_dl_cm):
    """log L and its error from flux via the delta method:
    sigma_logL = sigma_F / (F ln 10)."""
    lum = loglum_from_logflux(np.log10(flux), log_dl_cm)
    lum_e = None if flux_e is None else flux_e / (flux * np.log(10.0))
    return lum, lum_e


def propagate_lum_to_flux(lum, lum_e, log_dl_cm):
    """Inverse conversion."""
    logf = logflux_from_loglum(lum, log_dl_cm)
    flux = 10.0**logf
    flux_e = None if lum_e is None else lum_e * np.log(10.0) * flux
    return flux, flux_e


def build_context(cfg: LFConfig,
                  z,
                  flux=None, flux_e=None,
                  lum=None, lum_e=None,
                  field_id=None,
                  device="cpu",
                  dtype=torch.float64):
    """Build (LFData, LFContext) from a concatenated catalog.

    ``flux``/``flux_e`` are in units of 1e-17 erg/cm^2/s. All precompute
    runs in float64 numpy on the host; the returned tensors are cast to
    ``dtype`` on ``device``.
    """
    z = np.asarray(z, dtype=np.float64)
    n = z.shape[0]
    if n == 0:
        raise ValueError("empty catalog: no sources after cuts")
    if field_id is None:
        field_id = np.zeros(n, dtype=np.int32)
    field_id = np.asarray(field_id, dtype=np.int32)
    nfields = len(cfg.Flim)
    if field_id.min() < 0:
        raise ValueError("field_id contains negative entries")
    if field_id.max() >= nfields:
        raise ValueError(
            f"field_id goes up to {int(field_id.max())} but the config "
            f"provides only {nfields} Flim values — supply one "
            f"Flim/Omega_0 per field")
    if len(cfg.Omega_0) < nfields:
        raise ValueError(
            f"Omega_0 has {len(cfg.Omega_0)} entries for {nfields} "
            f"fields")

    zmin, zmax = float(z.min()), float(z.max())
    tabs = build_cosmo_arrays(zmax=1.05 * zmax + 0.1)
    cosmo = cosmo_table_from_arrays(tabs, device, dtype)
    zg = tabs["zgrid"]
    logdl_tab = tabs["log10_dl_cm"]
    dvdz_tab = tabs["dvdz_sr"]

    def log_dl_cm(zq):
        return np.interp(zq, zg, logdl_tab)

    def dvdz(zq):
        return np.interp(zq, zg, dvdz_tab)

    # --- fluxes <-> luminosities ---
    log_dl_src = log_dl_cm(z)
    if flux is not None:
        flux = 1.0e-17 * np.asarray(flux, dtype=np.float64)
        flux_e = None if flux_e is None else 1.0e-17 * np.asarray(
            flux_e, dtype=np.float64)
        lum, lum_e = propagate_flux_to_lum(flux, flux_e, log_dl_src)
    else:
        lum = np.asarray(lum, dtype=np.float64)
        lum_e = None if lum_e is None else np.asarray(lum_e, dtype=np.float64)
        flux, flux_e = propagate_lum_to_flux(lum, lum_e, log_dl_src)

    # --- per-field build-time completeness parameters ---
    flim_cgs = 1.0e-17 * np.asarray(cfg.Flim, dtype=np.float64)
    logF50 = np.log10(flim_cgs)
    alpha_c = float(cfg.alpha)

    if cfg.min_comp_frac > 0.001:
        roots_logf = fleming_root_logf_np(logF50, alpha_c,
                                          cfg.min_comp_frac, cfg.fcmin)
    else:
        roots_logf = np.full(nfields, -np.inf)

    # --- frozen likelihood grids ---
    gauss = cfg.quadrature == "gauss"
    if cfg.size_ln is not None:
        size = int(cfg.size_ln)
    elif gauss:
        size = 32
    else:
        size = 201 if cfg.fix_comp else 101

    lum_floor = float(lum.min())

    def minlum_of_z(f, zq):
        if cfg.min_comp_frac > 0.001:
            return np.maximum(roots_logf[f] + _LOG10_4PI
                              + 2.0 * log_dl_cm(zq), lum_floor)
        return np.full_like(np.asarray(zq, dtype=np.float64), lum_floor)

    if gauss:
        u_nodes, u_w = np.polynomial.legendre.leggauss(size)
        u_nodes = 0.5 * (u_nodes + 1.0)
        u_w = 0.5 * u_w
        # per field, split the z integral at the kink where the
        # completeness luminosity floor crosses min(lum): the integrand
        # is analytic on each panel, so GL converges spectrally
        zarr = np.empty((nfields, size))
        wz_arr = np.empty((nfields, size))
        for f in range(nfields):
            zstar = None
            if cfg.min_comp_frac > 0.001:
                raw = (roots_logf[f] + _LOG10_4PI
                       + 2.0 * log_dl_cm(np.array([zmin, zmax])))
                if raw[0] < lum_floor < raw[1]:
                    target_logdl = 0.5 * (lum_floor - roots_logf[f]
                                          - _LOG10_4PI)
                    zstar = float(np.interp(target_logdl, logdl_tab, zg))
            if zstar is None or not (zmin < zstar < zmax):
                zarr[f] = zmin + u_nodes * (zmax - zmin)
                wz_arr[f] = u_w * (zmax - zmin)
            else:
                n1 = size // 2
                n2 = size - n1
                x1, w1 = np.polynomial.legendre.leggauss(n1)
                x2, w2 = np.polynomial.legendre.leggauss(n2)
                zarr[f, :n1] = zmin + 0.5 * (x1 + 1.0) * (zstar - zmin)
                wz_arr[f, :n1] = 0.5 * w1 * (zstar - zmin)
                zarr[f, n1:] = zstar + 0.5 * (x2 + 1.0) * (zmax - zstar)
                wz_arr[f, n1:] = 0.5 * w2 * (zmax - zstar)
    else:
        zarr1 = np.linspace(zmin, zmax, size)
        wz = np.ones(size); wz[0] = wz[-1] = 0.5
        zarr = np.tile(zarr1, (nfields, 1))
        wz_arr = np.tile(wz * (zmax - zmin) / (size - 1), (nfields, 1))

    log_dl_zarr = log_dl_cm(zarr)                   # (F, S)
    volume_part = dvdz(zarr)                        # (F, S)
    minlum = np.stack([minlum_of_z(f, zarr[f]) for f in range(nfields)])

    span = cfg.Lh - minlum                          # (F, S) column spans
    if gauss:
        logL_grid = (minlum[:, None, :]
                     + u_nodes[None, :, None] * span[:, None, :])
        wL_col = u_w[None, :, None] * span[:, None, :]   # (F, S, S)
        w_open = wL_col * (wz_arr * volume_part)[:, None, :]
    else:
        # reference semantics: logL[f, :, j] = linspace(minlum, Lh, size)
        ii = np.linspace(0.0, 1.0, size)[None, :, None]
        logL_grid = minlum[:, None, :] + ii * span[:, None, :]
        dL_col = span / (size - 1)                  # (F, S) per-column dx
        wL = np.ones(size); wL[0] = wL[-1] = 0.5
        w_open = (wL[None, :, None]
                  * (wz_arr * volume_part)[:, None, :]
                  * dL_col[:, None, :])

    # frozen Omega on the grid
    logf_grid = logL_grid - _LOG10_4PI - 2.0 * log_dl_zarr[:, None, :]
    omega0_arr = np.asarray(cfg.Omega_0, dtype=np.float64)
    om_grid = (omega0_arr[:, None, None] / SQARCSEC_PER_SR
               * fleming_from_logf_np(logf_grid, logF50[:, None, None],
                                      alpha_c, cfg.fcmin))
    w_fixed = w_open * om_grid

    # --- per-source Omega at build-time parameters ---
    omega0_f = omega0_arr
    omega0_src = omega0_f[field_id]
    logF50_src = logF50[field_id]
    logf_src = lum - _LOG10_4PI - 2.0 * log_dl_src
    om_src = (omega0_src / SQARCSEC_PER_SR
              * fleming_from_logf_np(logf_src, logF50_src, alpha_c,
                                     cfg.fcmin))
    if not np.all(om_src > 0.0):
        # a source far below its field's F50 underflows the Fleming
        # curve to exactly 0, which would bake ln(0) = -inf into every
        # likelihood evaluation
        bad = int(np.sum(om_src <= 0.0))
        raise ValueError(
            f"{bad} source(s) have zero completeness at their flux "
            "(far below the field's F50) — every lnlike would be -inf. "
            "Raise min_comp_frac or remove the sources.")
    ln_om_src = np.log(om_src)

    # the anchor as the context carries it (rounded to ``dtype``), so the
    # sums below are taken against the same lref as every later use: in
    # float32 a 2e-6 shift of lref biases sum_pow_lum by 5e-6, which the
    # Lstar gradient of the collapsed ln-term (~N ln10 in size) amplifies
    lref = float(torch.tensor(float(lum.max()), dtype=dtype))

    def cast(a):   # a copy: the host arrays may be read-only or reused
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                            device=device)

    fid = torch.tensor(field_id, dtype=torch.int64, device=device)
    data = LFData(
        z=cast(z), lum=cast(lum),
        lum_e=None if lum_e is None else cast(lum_e),
        flux=cast(flux),
        flux_e=None if flux_e is None else cast(flux_e),
        field_id=fid,
    )
    pow_lum = 10.0 ** (lum - lref)
    nsrc_f = np.bincount(field_id, minlength=nfields).astype(np.float64)
    sum_lum_f = np.bincount(field_id, weights=lum, minlength=nfields)
    sum_pow_f = np.bincount(field_id, weights=pow_lum, minlength=nfields)
    sum_lnom_f = np.bincount(field_id, weights=ln_om_src,
                             minlength=nfields)

    ctx = LFContext(
        nsrc=cast(float(n)),
        sum_lum=cast(lum.sum()),
        lref=cast(lref),
        sum_pow_lum=cast(pow_lum.sum()),
        sum_ln_om=cast(ln_om_src.sum()),
        nsrc_f=cast(nsrc_f),
        sum_lum_f=cast(sum_lum_f),
        sum_pow_lum_f=cast(sum_pow_f),
        sum_ln_om_f=cast(sum_lnom_f),
        lum=cast(lum), zsrc=cast(z), logf_src=cast(logf_src),
        omega0_src=cast(omega0_src), ln_om_src=cast(ln_om_src),
        field_id=fid,
        src_mask=cast(np.ones(n)),
        z_lo=cast(zmin), z_hi=cast(zmax),
        zarr=cast(zarr), log_dl_zarr=cast(log_dl_zarr),
        volume_part=cast(volume_part),
        logL_grid=cast(logL_grid), w_fixed=cast(w_fixed),
        w_open=cast(w_open), logf_grid=cast(logf_grid),
        omega0_f=cast(omega0_f), logF50_f=cast(logF50),
        alpha_c=cast(alpha_c), roots_logf=cast(roots_logf),
        cosmo=cosmo,
    )
    return data, ctx
