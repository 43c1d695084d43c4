"""Redshift-evolving Schechter likelihood: the eager engine (port of
``lumfuncmcmc_tpu/models/likelihood_z.py``).

Theta packs three (logL*, logphi*) pivot values plus optionally a
constant alpha; (L*, phi*)(z) are the quadratics through the pivots.
Completeness is always fixed in this model, so the frozen ``w_fixed``
grid and the per-source ``ln Omega`` cache apply directly. The
per-source ln-term cannot collapse to O(1) here (phi depends on each
source's z through the quadratics), so it stays an N-vector reduction.

As in :mod:`~lumfuncmcmc_tpu_torch.models.likelihood`, every function
takes a batch of thetas, (W, D), and returns (W,). The hand-kernel
engine is :func:`lumfuncmcmc_tpu_torch.ops.cuda_lnlike.make_cuda_lnprob_z`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.models.context import LFContext
from lumfuncmcmc_tpu_torch.ops.schechter import log_schechter_z

NPIVOT = 6      # leading theta entries under the strict prior


@dataclass(frozen=True)
class ThetaLayoutZ:
    """Reference parameterization: theta = [L1, L2, L3, phi1, phi2,
    phi3] (+ [sch_al] if free).

    ``z_param="natural"``: theta = [Lmid, Lslope, Lcurv, pmid, pslope,
    pcurv] (+ [sch_al]), the quadratic's value, slope and curvature at
    the central pivot z2. Uniform priors on pivot values are informative
    about the curvature direction; uniform priors on the natural
    coefficients are flat in it. ``unpack`` always returns pivot values,
    so the likelihood is unchanged.
    """

    names: tuple
    lo: tuple
    hi: tuple
    fix_sch_al: bool
    sch_al0: float
    z1: float
    z2: float
    z3: float
    natural: bool = False

    @property
    def ndim(self) -> int:
        return len(self.names)

    @classmethod
    def from_config(cls, cfg: LFConfig) -> "ThetaLayoutZ":
        natural = cfg.z_param == "natural"
        if natural:
            names = ["Lmid", "Lslope", "Lcurv", "pmid", "pslope", "pcurv"]
            lo = [cfg.Lstar_lims[0], -3.0, -6.0,
                  cfg.phistar_lims[0], -5.0, -10.0]
            hi = [cfg.Lstar_lims[1], 3.0, 6.0,
                  cfg.phistar_lims[1], 5.0, 10.0]
        else:
            names = ["L1", "L2", "L3", "phi1", "phi2", "phi3"]
            lo = [cfg.Lstar_lims[0]] * 3 + [cfg.phistar_lims[0]] * 3
            hi = [cfg.Lstar_lims[1]] * 3 + [cfg.phistar_lims[1]] * 3
        if not cfg.fix_sch_al:
            names.append("sch_al")
            lo.append(cfg.sch_al_lims[0]); hi.append(cfg.sch_al_lims[1])
        return cls(names=tuple(names), lo=tuple(lo), hi=tuple(hi),
                   fix_sch_al=cfg.fix_sch_al, sch_al0=cfg.sch_al,
                   z1=cfg.z1, z2=cfg.z2, z3=cfg.z3, natural=natural)

    def plot_names(self):
        """LaTeX labels in theta order."""
        if self.natural:
            out = [r"$\log L_*(z_2)$", r"$dL_*/dz$", r"$d^2L_*/dz^2$",
                   r"$\log \phi_*(z_2)$", r"$d\phi_*/dz$",
                   r"$d^2\phi_*/dz^2$"]
        else:
            out = [r"$\log {\rm{L}}1_*$", r"$\log {\rm{L}}2_*$",
                   r"$\log {\rm{L}}3_*$", r"$\log \phi1_*$",
                   r"$\log \phi2_*$", r"$\log \phi3_*$"]
        if not self.fix_sch_al:
            out.append(r"$\alpha$")
        return out

    def unpack(self, theta):
        """(W, D) thetas -> (L1, L2, L3, phi1, phi2, phi3, sch_al) pivot
        values, each (W,)."""
        if self.natural:
            dz1, dz3 = self.z1 - self.z2, self.z3 - self.z2
            Lm, Ls, Lc = theta[:, 0], theta[:, 1], theta[:, 2]
            pm, ps, pc = theta[:, 3], theta[:, 4], theta[:, 5]
            L1 = Lm + Ls * dz1 + Lc * dz1 * dz1
            L3 = Lm + Ls * dz3 + Lc * dz3 * dz3
            p1 = pm + ps * dz1 + pc * dz1 * dz1
            p3 = pm + ps * dz3 + pc * dz3 * dz3
            L2, p2 = Lm, pm
        else:
            L1, L2, L3 = theta[:, 0], theta[:, 1], theta[:, 2]
            p1, p2, p3 = theta[:, 3], theta[:, 4], theta[:, 5]
        sch_al = (torch.full_like(L2, self.sch_al0) if self.fix_sch_al
                  else theta[:, 6])
        return L1, L2, L3, p1, p2, p3, sch_al

    def bounds_arrays(self, dtype, device):
        return (torch.tensor(self.lo, dtype=dtype, device=device),
                torch.tensor(self.hi, dtype=dtype, device=device))


def in_box_z(theta, lo, hi):
    """(W, D) thetas -> (W,) bool: strictly inside the box on the six
    pivot entries (``>``/``<``, as the reference), inclusive on
    ``sch_al`` when it is free."""
    ok = torch.all((theta[:, :NPIVOT] > lo[:NPIVOT])
                   & (theta[:, :NPIVOT] < hi[:NPIVOT]), dim=1)
    if theta.shape[1] > NPIVOT:
        ok = ok & torch.all((theta[:, NPIVOT:] >= lo[NPIVOT:])
                            & (theta[:, NPIVOT:] <= hi[NPIVOT:]), dim=1)
    return ok


def lnprior_z(theta, layout: ThetaLayoutZ):
    """Box prior, strict on the pivots: 0 inside, -inf outside.
    (W, D) -> (W,)."""
    lo, hi = layout.bounds_arrays(theta.dtype, theta.device)
    return torch.where(in_box_z(theta, lo, hi), 0.0,
                       -math.inf).to(theta.dtype)


def lnlike_z_parts(theta, ctx: LFContext, layout: ThetaLayoutZ):
    """(lnpart, fullint), each (W,): the per-source reduction and the
    grid integral (lnL = lnpart - fullint)."""
    piv = layout.unpack(theta)
    zp = (layout.z1, layout.z2, layout.z3)
    al = piv[6]

    src = [p[:, None] for p in piv[:6]]                     # (W, 1)
    lnphi_src = log_schechter_z(ctx.lum, ctx.zsrc, al[:, None], *src, *zp)
    contrib = torch.where(ctx.src_mask > 0, lnphi_src + ctx.ln_om_src,
                          torch.zeros_like(lnphi_src))
    lnpart = contrib.sum(dim=1)

    # grid: per-field z nodes broadcast along the L axis
    cell = (slice(None), None, None, None)                  # (W, 1, 1, 1)
    lnphi_grid = log_schechter_z(ctx.logL_grid, ctx.zarr[:, None, :],
                                 al[cell], *(p[cell] for p in piv[:6]),
                                 *zp)
    fullint = (torch.exp(lnphi_grid) * ctx.w_fixed).sum(dim=(1, 2, 3))
    return lnpart, fullint


def lnlike_z(theta, ctx: LFContext, layout: ThetaLayoutZ):
    """lnL for the z-evolving model. (W, D) -> (W,)."""
    lnpart, fullint = lnlike_z_parts(theta, ctx, layout)
    return lnpart - fullint


def make_lnprob_z(ctx: LFContext, layout: ThetaLayoutZ):
    """Build the batched lnprob, (W, D) -> (W,): the likelihood is
    always evaluated and masked by the strict prior."""
    # bounds made once: a host tensor per call would sync the device
    lo, hi = layout.bounds_arrays(ctx.lum.dtype, ctx.lum.device)

    def lnprob(theta):
        lnl = lnlike_z(theta, ctx, layout)
        return torch.where(in_box_z(theta, lo, hi), lnl,
                           torch.full_like(lnl, -math.inf))

    return lnprob
