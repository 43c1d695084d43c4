"""Plain reference of the free-completeness luminosity-function posterior.

Written from the model's equations, independent of the program under
test: it imports nothing of it and works every quantity out again from a
catalog (redshifts, fluxes, fields) and a configuration file. The
posterior of a theta row ``[L*, log phi*, alpha, Flim_0..Flim_{F-1},
alpha_C]`` inside its prior box is

    lnL = sum_n [ ln phi(L_n) + ln Omega_f(n)(L_n, z_n) ]
          - sum_f sum_{i,j} phi(logL_fij) Omega_f(logL_fij, z_fj) w_fij

with phi the Schechter function in log L, Omega_f the field's area times
the modified Fleming completeness of the implied flux, and the double
integral taken by the configuration's quadrature (trapezoid or
Gauss-Legendre, ``size`` nodes a side) over z in [min z, max z] of the
catalog and log L from the completeness floor ``minlum_f(z)`` (the
``min_comp_frac`` root of the build-time curve, raised to the faintest
source) to ``Lh``. Outside the prior box the posterior is -inf.

The context is built in float64 NumPy on the host; the posterior is
evaluated in torch, in any dtype and on any device, so that the same code
gives the float64 reference, its gradient by autograd, and the
lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LN10 = math.log(10.0)
LOG10_4PI = math.log10(4.0 * math.pi)
SQARCSEC_PER_SR = (180.0 / math.pi * 3600.0) ** 2
_GL_X, _GL_W = np.polynomial.legendre.leggauss(64)


class Cosmology:
    """FLRW background from a configuration's ``cosmology`` block: matter,
    a cosmological constant, radiation (photons and massless neutrinos
    from Tcmb0 and Neff) and the curvature that closes the budget.
    Distances by 64-node Gauss-Legendre integration of 1/E(z)."""

    def __init__(self, c: dict):
        self.om, self.ode = float(c["Om0"]), float(c["Ode0"])
        cc, g, sb, mpc = (float(c["c_m_s"]), float(c["G"]),
                          float(c["sigma_sb"]), float(c["mpc_m"]))
        h0 = float(c["H0"]) * 1000.0 / mpc
        rho_crit = 3.0 * h0 ** 2 / (8.0 * math.pi * g)
        rho_gamma = 4.0 * sb / cc * float(c["Tcmb0"]) ** 4 / cc ** 2
        og = rho_gamma / rho_crit
        self.orad = og * (1.0 + float(c["Neff"]) * 0.875
                          * (4.0 / 11.0) ** (4.0 / 3.0))
        self.ok = 1.0 - self.om - self.ode - self.orad
        self.d_h = cc / h0 / mpc                       # Mpc
        self.mpc_cm = float(c["mpc_cm_flux"])

    def efunc(self, z):
        zp1 = 1.0 + z
        return np.sqrt(self.om * zp1 ** 3 + self.ok * zp1 ** 2
                       + self.orad * zp1 ** 4 + self.ode)

    def comoving_mpc(self, z):
        z = np.asarray(z, dtype=np.float64)
        out = np.empty(z.shape)
        flat, res = z.reshape(-1), out.reshape(-1)
        for a in range(0, flat.size, 1 << 15):
            zz = flat[a:a + (1 << 15), None]
            nodes = 0.5 * zz * (_GL_X[None, :] + 1.0)
            res[a:a + (1 << 15)] = (0.5 * zz[:, 0]
                                    * (_GL_W / self.efunc(nodes)).sum(1))
        return self.d_h * out

    def transverse_mpc(self, z):
        dc = self.comoving_mpc(z)
        if abs(self.ok) < 1e-12:
            return dc
        sq = math.sqrt(abs(self.ok))
        f = np.sinh if self.ok > 0 else np.sin
        return self.d_h / sq * f(sq * dc / self.d_h)

    def log10_dl_cm(self, z):
        z = np.asarray(z, dtype=np.float64)
        return np.log10((1.0 + z) * self.transverse_mpc(z) * self.mpc_cm)

    def dvdz_sr(self, z):
        z = np.asarray(z, dtype=np.float64)
        return self.d_h * self.transverse_mpc(z) ** 2 / self.efunc(z)

    def z_at_log10_dl_cm(self, target, zhi=10.0):
        """The z where log10 dL equals ``target`` (bisection)."""
        lo, hi = np.zeros_like(target), np.full_like(target, zhi)
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            up = self.log10_dl_cm(mid) < target
            lo, hi = np.where(up, mid, lo), np.where(up, hi, mid)
        return 0.5 * (lo + hi)


def fleming(logf, logf50, alpha, fcmin, xp=np):
    """Modified Fleming completeness of log10 fluxes: the curve
    0.5 (1 + x / sqrt(1 + x^2)), x = alpha (logf - logf50), raised to
    1 / (1 - exp(-f / f_tau)) with f_tau the flux where the plain curve
    is ``fcmin``. ``xp`` is numpy or torch."""
    x = alpha * (logf - logf50)
    fc = 0.5 * (1.0 + x / xp.sqrt(1.0 + x * x))
    s = 2.0 * fcmin - 1.0
    ratio = math.copysign(math.sqrt(s * s / (1.0 - s * s)), s)
    log_ftau = logf50 + ratio / alpha
    decay = 1.0 - xp.exp(-xp.exp(xp.clip((logf - log_ftau) * LN10,
                                         None, 40.0)))
    return xp.exp(xp.log(fc) / decay)


def completeness_root(logf50, alpha, frac, fcmin):
    """log10 flux where the modified curve reaches ``frac``."""
    lo, hi = logf50 - 6.0, logf50 + 6.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        up = fleming(mid, logf50, alpha, fcmin) < frac
        lo, hi = np.where(up, mid, lo), np.where(up, hi, mid)
    return 0.5 * (lo + hi)


class Reference:
    """The posterior of one catalog under one configuration file."""

    def __init__(self, config: dict, z, flux, field_id):
        lf = config["lfconfig"]
        cosmo = Cosmology(config["cosmology"])
        z = np.asarray(z, dtype=np.float64)
        fid = np.asarray(field_id, dtype=np.int64)
        flim = np.asarray(lf["Flim"], dtype=np.float64)
        nf = flim.size
        self.nfields = nf
        self.fcmin = float(lf["fcmin"])
        self.lo = np.array([lf["Lstar_lims"][0], lf["phistar_lims"][0],
                            lf["sch_al_lims"][0]]
                           + [lf["Flim_lims"][0]] * nf
                           + [lf["alpha_lims"][0]], dtype=np.float64)
        self.hi = np.array([lf["Lstar_lims"][1], lf["phistar_lims"][1],
                            lf["sch_al_lims"][1]]
                           + [lf["Flim_lims"][1]] * nf
                           + [lf["alpha_lims"][1]], dtype=np.float64)
        logf = np.log10(np.asarray(flux, dtype=np.float64)) - 17.0
        log_dl = cosmo.log10_dl_cm(z)
        lum = logf + LOG10_4PI + 2.0 * log_dl
        omega0 = np.asarray(lf["Omega_0"], dtype=np.float64)
        logf50 = np.log10(flim) - 17.0
        alpha_c = float(lf["alpha"])
        mcf = float(lf["min_comp_frac"])
        roots = (completeness_root(logf50, alpha_c, mcf, self.fcmin)
                 if mcf > 0.001 else np.full(nf, -np.inf))
        zmin, zmax = float(z.min()), float(z.max())
        floor = float(lum.min())
        size = int(lf["size_ln"])
        gauss = lf["quadrature"] == "gauss"
        zs, wz = np.empty((nf, size)), np.empty((nf, size))
        for f in range(nf):
            if gauss:
                zs[f], wz[f] = self._gauss_z(cosmo, roots[f], floor,
                                             zmin, zmax, size)
            else:
                zs[f] = np.linspace(zmin, zmax, size)
                wz[f] = (zmax - zmin) / (size - 1)
                wz[f, [0, -1]] *= 0.5
        ldl = cosmo.log10_dl_cm(zs)                         # (F, S)
        minlum = np.maximum(roots[:, None] + LOG10_4PI + 2.0 * ldl, floor)
        span = float(lf["Lh"]) - minlum
        if gauss:
            u, wu = np.polynomial.legendre.leggauss(size)
            u, wu = 0.5 * (u + 1.0), 0.5 * wu
        else:
            u = np.linspace(0.0, 1.0, size)
            wu = np.full(size, 1.0 / (size - 1))
            wu[[0, -1]] *= 0.5
        logl = minlum[:, None, :] + u[None, :, None] * span[:, None, :]
        w = (wu[None, :, None] * span[:, None, :]
             * (wz * cosmo.dvdz_sr(zs))[:, None, :])
        self.host = {
            "lum": lum, "logf": logf, "field": fid,
            "om0_src": omega0[fid] / SQARCSEC_PER_SR,
            "g_logl": logl.reshape(nf, -1),
            "g_logf": (logl - LOG10_4PI - 2.0 * ldl[:, None, :]).reshape(
                nf, -1),
            "g_w": w.reshape(nf, -1),
            "g_om0": omega0 / SQARCSEC_PER_SR}
        self.nsources = lum.size
        self.ncells = int(logl.size)

    @staticmethod
    def _gauss_z(cosmo, root, floor, zmin, zmax, size):
        """Gauss-Legendre z nodes and weights, split in two panels at the
        kink where the completeness floor crosses the faintest source."""
        x, w = np.polynomial.legendre.leggauss(size)
        zstar = None
        if np.isfinite(root):
            raw = root + LOG10_4PI + 2.0 * cosmo.log10_dl_cm(
                np.array([zmin, zmax]))
            if raw[0] < floor < raw[1]:
                zstar = float(cosmo.z_at_log10_dl_cm(
                    np.array(0.5 * (floor - root - LOG10_4PI))))
        if zstar is None or not zmin < zstar < zmax:
            return zmin + 0.5 * (x + 1.0) * (zmax - zmin), 0.5 * w * (
                zmax - zmin)
        n1 = size // 2
        x1, w1 = np.polynomial.legendre.leggauss(n1)
        x2, w2 = np.polynomial.legendre.leggauss(size - n1)
        zs = np.concatenate([zmin + 0.5 * (x1 + 1.0) * (zstar - zmin),
                             zstar + 0.5 * (x2 + 1.0) * (zmax - zstar)])
        ws = np.concatenate([0.5 * w1 * (zstar - zmin),
                             0.5 * w2 * (zmax - zstar)])
        return zs, ws

    def tensors(self, dtype, device):
        """The context in ``dtype`` on ``device``."""
        out = {}
        for k, v in self.host.items():
            out[k] = torch.as_tensor(
                v, dtype=torch.int64 if k == "field" else dtype,
                device=device)
        out["lo"] = torch.as_tensor(self.lo, dtype=dtype, device=device)
        out["hi"] = torch.as_tensor(self.hi, dtype=dtype, device=device)
        return out

    def lnprob_fn(self, dtype=torch.float64, device="cpu", rows=16):
        """(B, D) thetas -> (B,) posterior, computed in ``dtype`` on
        ``device`` in blocks of ``rows`` rows; differentiable."""
        t = self.tensors(dtype, device)
        nf, fcmin = self.nfields, self.fcmin

        def block(th):
            lstar, phis, al = th[:, 0:1], th[:, 1:2], th[:, 2:3]
            logf50 = torch.log10(th[:, 3:3 + nf]) - 17.0       # (B, F)
            ac = th[:, 3 + nf:4 + nf]

            def lnphi(logl):
                x = logl - lstar
                return (math.log(LN10) + LN10 * phis
                        + LN10 * x * (al + 1.0) - torch.exp(LN10 * x))

            src = (lnphi(t["lum"][None, :])
                   + torch.log(t["om0_src"][None, :] * fleming(
                       t["logf"][None, :], logf50[:, t["field"]], ac,
                       fcmin, xp=torch)))
            integ = 0.0
            for f in range(nf):
                om = t["g_om0"][f] * fleming(t["g_logf"][f][None, :],
                                             logf50[:, f:f + 1], ac, fcmin,
                                             xp=torch)
                integ = integ + (torch.exp(lnphi(t["g_logl"][f][None, :]))
                                 * om * t["g_w"][f][None, :]).sum(1)
            val = src.sum(1) - integ
            inside = ((th >= t["lo"]) & (th <= t["hi"])).all(1)
            return torch.where(inside, val, torch.full_like(val, -math.inf))

        def fn(theta):
            theta = theta.to(dtype=dtype, device=device)
            return torch.cat([block(theta[a:a + rows])
                              for a in range(0, theta.shape[0], rows)])

        return fn

    def value_and_grad(self, theta, device="cpu", rows=16):
        """float64 values (B,) and gradients (B, D) by autograd, as host
        arrays."""
        fn = self.lnprob_fn(torch.float64, device, rows)
        vals, grads = [], []
        th = torch.as_tensor(np.asarray(theta, dtype=np.float64),
                             device=device)
        for a in range(0, th.shape[0], rows):
            x = th[a:a + rows].clone().requires_grad_(True)
            v = fn(x)
            (g,) = torch.autograd.grad(v.sum(), x)
            vals.append(v.detach().cpu().numpy())
            grads.append(g.cpu().numpy())
        return np.concatenate(vals), np.concatenate(grads)


def build(config: dict, catalog: dict) -> Reference:
    """The reference of a configuration that names this file."""
    if config["lfconfig"].get("fix_comp"):
        raise ValueError("reference/lf.py is the free-completeness "
                         "posterior; fixed completeness needs its own")
    return Reference(config, catalog["z"], catalog["flux"],
                     catalog["field_id"])
