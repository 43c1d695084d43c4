"""Synthetic emission-line catalogs of a survey from a seed: the same
inhomogeneous Poisson process as ``poisson_fields`` (phi(logL) dV/dz
Omega_f(logL, z) of the configuration's true Schechter parameters on its
(logL, z) grid of cells), with the number of sources set by the survey and
not by a target: each field gets the expected count of its intensity over
its own area ``Omega_0``, above its ``min_comp_frac`` completeness root.
So a configuration whose areas and flux limits are a real survey's gets
that survey's catalog size, the same for every seed; only which sources
come from the seed. A configuration names this generator by its
``catalog`` block's ``generator`` key.

The catalog block may carry ``area_scale`` (default 1), which multiplies
every field's area, for tests that need a smaller catalog of the same
survey.
"""

from __future__ import annotations

import copy

import numpy as np

from portbench.catalogs import poisson_fields
from portbench.reference.lf import (
    LOG10_4PI, SQARCSEC_PER_SR, Cosmology, completeness_root, fleming)


def _scaled(config: dict) -> dict:
    """``config`` with every field's area times the catalog's
    ``area_scale``."""
    out = copy.deepcopy(config)
    s = float(out["catalog"].get("area_scale", 1.0))
    out["lfconfig"]["Omega_0"] = [s * float(a)
                                  for a in out["lfconfig"]["Omega_0"]]
    return out


def intensities(config: dict):
    """``(per-field intensity (F, ngrid, ngrid), log10 flux of each cell
    (ngrid, ngrid), roots (F,))``: the expected sources of each (logL, z)
    cell and field, on ``poisson_fields``' grid."""
    lf, spec = config["lfconfig"], config["catalog"]
    cosmo = Cosmology(config["cosmology"])
    zmin, zmax, ngrid = (float(spec["zmin"]), float(spec["zmax"]),
                         int(spec["ngrid"]))
    ztab = np.linspace(0.0, 1.05 * zmax + 0.1, 8193)
    ldl_tab = cosmo.log10_dl_cm(np.maximum(ztab, 1e-6))
    zc = np.linspace(zmin, zmax, ngrid)
    lc = np.linspace(lf["Lc"] + 0.5, lf["Lh"] - 1.0, ngrid)
    dz, dl = zc[1] - zc[0], lc[1] - lc[0]
    ldl = np.interp(zc, ztab, ldl_tab)
    x = lc - lf["Lstar"]
    phi = (np.log(10.0) * 10.0 ** lf["phistar"]
           * 10.0 ** (x * (lf["sch_al"] + 1.0)) * np.exp(-(10.0 ** x)))
    logf50 = np.log10(np.asarray(lf["Flim"], dtype=np.float64)) - 17.0
    alpha, fcmin = float(lf["alpha"]), float(lf["fcmin"])
    roots = completeness_root(logf50, alpha, float(lf["min_comp_frac"]),
                              fcmin)
    logf_cell = lc[:, None] - LOG10_4PI - 2.0 * ldl[None, :]
    inten = np.stack([
        phi[:, None] * cosmo.dvdz_sr(zc)[None, :]
        * (lf["Omega_0"][f] / SQARCSEC_PER_SR
           * fleming(logf_cell, logf50[f], alpha, fcmin)) * dz * dl
        for f in range(logf50.size)])
    return inten, logf_cell, roots


def expected_counts(config: dict) -> np.ndarray:
    """(F,) int: the sources each field gets, the rounded expected count
    of its cells above its root (at its scaled area)."""
    inten, logf_cell, roots = intensities(_scaled(config))
    return np.array([int(round(i[logf_cell > r].sum()))
                     for i, r in zip(inten, roots)])


def make(config: dict, seed: int) -> dict:
    """``{"z", "flux" (1e-17 cgs), "flux_e", "field_id"}`` for the
    configuration's ``catalog`` block and ``--seed``: ``poisson_fields``'
    draws with its target set to the grid's whole expected count, so that
    its scale is 1 and each field keeps its expected count."""
    cfg = _scaled(config)
    cfg["catalog"]["n_target"] = float(sum(i.sum()
                                           for i in intensities(cfg)[0]))
    return poisson_fields.make(cfg, seed)
