"""Synthetic emission-line catalogs from a seed: the inhomogeneous Poisson
process phi(logL) dV/dz Omega_f(logL, z) of a configuration's true
Schechter parameters, on a (logL, z) grid of cells, as the program's own
synthetic catalogs draw it, with one change: every seed gets the same
number of sources in each field, the expected number above the field's
``min_comp_frac`` completeness root, so the work of a run does not
depend on its seed. Only which sources, not how many, come from the
seed. A configuration names this generator by its ``catalog`` block's
``generator`` key.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.lf import (
    LOG10_4PI, SQARCSEC_PER_SR, Cosmology, completeness_root, fleming)


def make(config: dict, seed: int) -> dict:
    """``{"z", "flux" (1e-17 cgs), "flux_e", "field_id"}``
    for the configuration's ``catalog`` block and ``--seed``."""
    lf, spec = config["lfconfig"], config["catalog"]
    cosmo = Cosmology(config["cosmology"])
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0xCA7A])
    zmin, zmax, ngrid = (float(spec["zmin"]), float(spec["zmax"]),
                         int(spec["ngrid"]))
    # distances on a dense table: the data need not be exact, only fixed
    ztab = np.linspace(0.0, 1.05 * zmax + 0.1, 8193)
    ldl_tab = cosmo.log10_dl_cm(np.maximum(ztab, 1e-6))
    zc = np.linspace(zmin, zmax, ngrid)
    lc = np.linspace(lf["Lc"] + 0.5, lf["Lh"] - 1.0, ngrid)
    dz, dl = zc[1] - zc[0], lc[1] - lc[0]
    ldl = np.interp(zc, ztab, ldl_tab)
    x = lc - lf["Lstar"]
    phi = (np.log(10.0) * 10.0 ** lf["phistar"]
           * 10.0 ** (x * (lf["sch_al"] + 1.0)) * np.exp(-(10.0 ** x)))
    flim = np.asarray(lf["Flim"], dtype=np.float64)
    logf50 = np.log10(flim) - 17.0
    alpha, fcmin = float(lf["alpha"]), float(lf["fcmin"])
    roots = completeness_root(logf50, alpha, float(lf["min_comp_frac"]),
                              fcmin)
    logf_cell = lc[:, None] - LOG10_4PI - 2.0 * ldl[None, :]
    intens = []
    for f in range(flim.size):
        om = (lf["Omega_0"][f] / SQARCSEC_PER_SR
              * fleming(logf_cell, logf50[f], alpha, fcmin))
        intens.append(phi[:, None] * cosmo.dvdz_sr(zc)[None, :] * om
                      * dz * dl)
    scale = float(spec["n_target"]) / sum(i.sum() for i in intens)
    out = {"z": [], "flux": [], "field_id": []}
    for f, inten in enumerate(intens):
        want = int(round(scale * inten[logf_cell > roots[f]].sum()))
        p = (inten / inten.sum()).ravel()
        got_z, got_f, n = [], [], 0
        while n < want:
            m = max(1024, int(1.5 * (want - n)))
            il, iz = np.unravel_index(rng.choice(p.size, size=m, p=p),
                                      inten.shape)
            lum = lc[il] + rng.uniform(-0.5, 0.5, m) * dl
            z = zc[iz] + rng.uniform(-0.5, 0.5, m) * dz
            logf = lum - LOG10_4PI - 2.0 * np.interp(z, ztab, ldl_tab)
            keep = logf > roots[f]
            got_z.append(z[keep])
            got_f.append(logf[keep])
            n += int(keep.sum())
        out["z"].append(np.concatenate(got_z)[:want])
        out["flux"].append(10.0 ** (np.concatenate(got_f)[:want] + 17.0))
        out["field_id"].append(np.full(want, f, dtype=np.int32))
    cat = {k: np.concatenate(v) for k, v in out.items()}
    cat["flux_e"] = 0.1 * cat["flux"]
    return cat
