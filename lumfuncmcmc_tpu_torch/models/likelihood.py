"""Single-epoch log-probability: the eager engine (port of
``lumfuncmcmc_tpu/models/likelihood.py``).

Every function takes a batch of thetas, shape (W, D), and returns (W,):
the batch dimension is written out where the JAX package ``vmap``s a
scalar function. This engine is the counterpart of the JAX package's XLA
path; the hand-kernel engine is :mod:`lumfuncmcmc_tpu_torch.ops.cuda_lnlike`.

The Poisson point-process likelihood is

    lnL(theta) = sum_n ln[ phi(L_n) * Omega(L_n, z_n) ]
               - sum_fields  integral phi(L) dV/dz Omega(L, z) dlogL dz

with the double integral a weighted sum over the frozen per-field grids
of :class:`~lumfuncmcmc_tpu_torch.models.context.LFContext`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.models.context import LFContext
from lumfuncmcmc_tpu_torch.ops.completeness import fleming_root_logf
from lumfuncmcmc_tpu_torch.ops.omega import LOG10_4PI, omega_from_logf
from lumfuncmcmc_tpu_torch.ops.quadrature import gl_nodes_unit
from lumfuncmcmc_tpu_torch.ops.schechter import LN10, log_true_lum_func

NEG_INF = -math.inf


@dataclass(frozen=True)
class ThetaLayout:
    """Static description of the packed parameter vector::

        [Lstar, phistar] (+ [sch_al] if free)
        (+ [Flim_0..Flim_{F-1}, alpha_c] if completeness free)
    """

    names: tuple
    lo: tuple
    hi: tuple
    fix_sch_al: bool
    fix_comp: bool
    nfields: int
    sch_al0: float
    flim0: tuple          # 1e-17 cgs units (reference convention)
    alpha0: float
    fcmin: float

    @property
    def ndim(self) -> int:
        return len(self.names)

    @classmethod
    def from_config(cls, cfg: LFConfig) -> "ThetaLayout":
        names = ["Lstar", "phistar"]
        lo = [cfg.Lstar_lims[0], cfg.phistar_lims[0]]
        hi = [cfg.Lstar_lims[1], cfg.phistar_lims[1]]
        if not cfg.fix_sch_al:
            names.append("sch_al")
            lo.append(cfg.sch_al_lims[0]); hi.append(cfg.sch_al_lims[1])
        if not cfg.fix_comp:
            for i in range(len(cfg.Flim)):
                names.append(f"Flim_{i}")
                lo.append(cfg.Flim_lims[0]); hi.append(cfg.Flim_lims[1])
            names.append("alpha")
            lo.append(cfg.alpha_lims[0]); hi.append(cfg.alpha_lims[1])
        return cls(names=tuple(names), lo=tuple(lo), hi=tuple(hi),
                   fix_sch_al=cfg.fix_sch_al, fix_comp=cfg.fix_comp,
                   nfields=len(cfg.Flim), sch_al0=cfg.sch_al,
                   flim0=tuple(cfg.Flim), alpha0=cfg.alpha,
                   fcmin=cfg.fcmin)

    def plot_names(self):
        """LaTeX labels in theta order."""
        out = [r"$\log L_*$", r"$\log \phi_*$"]
        if not self.fix_sch_al:
            out.append(r"$\alpha$")
        if not self.fix_comp:
            out += [r"$F_{{\rm 50},%d}$" % i for i in range(self.nfields)]
            out.append(r"$\alpha_C$")
        return out

    def unpack(self, theta):
        """(W, D) thetas -> (Lstar (W,), phistar (W,), sch_al (W,),
        logF50_cgs (W, F), alpha_c (W,))."""
        lstar, phistar = theta[:, 0], theta[:, 1]
        k = 2
        if self.fix_sch_al:
            sch_al = torch.full_like(lstar, self.sch_al0)
        else:
            sch_al = theta[:, k]; k += 1
        if self.fix_comp:
            # filled on the device: a host tensor here would cost a
            # host-device copy (and a sync) on every batch
            logf50 = torch.stack([torch.full_like(lstar,
                                                  math.log10(v) - 17.0)
                                  for v in self.flim0], dim=1)
            alpha_c = torch.full_like(lstar, self.alpha0)
        else:
            logf50 = torch.log10(theta[:, k:k + self.nfields]) - 17.0
            alpha_c = theta[:, k + self.nfields]
        return lstar, phistar, sch_al, logf50, alpha_c

    def bounds_arrays(self, dtype, device):
        return (torch.tensor(self.lo, dtype=dtype, device=device),
                torch.tensor(self.hi, dtype=dtype, device=device))


def in_box(theta, lo, hi):
    """(W, D) thetas -> (W,) bool: inside the [lo, hi] box."""
    return torch.all((theta >= lo) & (theta <= hi), dim=1)


def lnprior(theta, layout: ThetaLayout):
    """Uniform box prior: 0 inside, -inf outside. (W, D) -> (W,)."""
    lo, hi = layout.bounds_arrays(theta.dtype, theta.device)
    return torch.where(in_box(theta, lo, hi), 0.0,
                       NEG_INF).to(theta.dtype)


def _ln_term_collapsed(ctx: LFContext, lstar, phistar, sch_al):
    """O(1) exact form of sum_n ln phi(L_n) + sum_n ln Omega_n (fixed
    completeness)."""
    return (ctx.nsrc * (math.log(LN10) + LN10 * phistar)
            + LN10 * (sch_al + 1.0) * (ctx.sum_lum - ctx.nsrc * lstar)
            - torch.exp(LN10 * (ctx.lref - lstar)) * ctx.sum_pow_lum
            + ctx.sum_ln_om)


def _ln_term_direct(ctx: LFContext, lstar, phistar, sch_al, ln_om_src):
    """Per-source reduction sum_n [ln phi(L_n) + ln Omega_n]; masked
    sources contribute exactly 0. ``ln_om_src`` is (N,) or (W, N)."""
    lnphi = log_true_lum_func(ctx.lum, sch_al[:, None], lstar[:, None],
                              phistar[:, None])
    contrib = torch.where(ctx.src_mask > 0, lnphi + ln_om_src,
                          torch.zeros_like(lnphi))
    return contrib.sum(dim=1)


def lnlike_single_epoch_parts(theta, ctx: LFContext, layout: ThetaLayout,
                              collapse: bool = True):
    """(lnpart, fullint), each (W,), for the single-epoch model."""
    lstar, phistar, sch_al, logf50, alpha_c = layout.unpack(theta)
    cell = (slice(None), None, None, None)      # (W,) -> (W, 1, 1, 1)
    lnphi_grid = log_true_lum_func(ctx.logL_grid, sch_al[cell],
                                   lstar[cell], phistar[cell])
    if layout.fix_comp:
        lnpart = (_ln_term_collapsed(ctx, lstar, phistar, sch_al)
                  if collapse
                  else _ln_term_direct(ctx, lstar, phistar, sch_al,
                                       ctx.ln_om_src))
        fullint = (torch.exp(lnphi_grid) * ctx.w_fixed).sum(dim=(1, 2, 3))
    else:
        logf50_src = logf50[:, ctx.field_id]                # (W, N)
        om_src = omega_from_logf(ctx.logf_src, ctx.omega0_src, logf50_src,
                                 alpha_c[:, None], layout.fcmin)
        lnpart = _ln_term_direct(ctx, lstar, phistar, sch_al,
                                 torch.log(om_src))
        om_grid = omega_from_logf(
            ctx.logf_grid, ctx.omega0_f[:, None, None],
            logf50[:, :, None, None], alpha_c[cell], layout.fcmin)
        fullint = (torch.exp(lnphi_grid) * om_grid
                   * ctx.w_open).sum(dim=(1, 2, 3))
    return lnpart, fullint


def lnlike_single_epoch(theta, ctx: LFContext, layout: ThetaLayout,
                        collapse: bool = True):
    """lnL(theta) for the single-epoch Schechter model: frozen Omega and
    the collapsed ln-term under fixed completeness, Omega recomputed
    from theta on the frozen grid and per source under free."""
    lnpart, fullint = lnlike_single_epoch_parts(theta, ctx, layout,
                                                collapse=collapse)
    return lnpart - fullint


def lnlike_exact_bounds_parts(theta, ctx: LFContext, layout: ThetaLayout,
                              min_comp_frac: float, lum_floor: float,
                              lh: float, n_nodes: int = 32):
    """(lnpart, fullint), each (W,), of :func:`lnlike_exact_bounds`."""
    lstar, phistar, sch_al, logf50, alpha_c = layout.unpack(theta)
    dt, dev = theta.dtype, theta.device
    logf50_src = logf50[:, ctx.field_id]                # (W, N)
    om_src = omega_from_logf(ctx.logf_src, ctx.omega0_src, logf50_src,
                             alpha_c[:, None], layout.fcmin)
    lnpart = _ln_term_direct(ctx, lstar, phistar, sch_al,
                             torch.log(om_src))
    u, w = (torch.as_tensor(x, dtype=dt, device=dev)
            for x in gl_nodes_unit(n_nodes))
    # the true data z-range (context scalars)
    zmin, zmax = ctx.z_lo, ctx.z_hi
    # broadcast shapes: (W, panel, field, L node, z node)
    wb = (slice(None), None, None, None, None)
    if min_comp_frac > 0.001:
        # the completeness root per walker and field; minlum(z) = max(
        # root-implied bound, lum_floor) has a kink where the branches
        # cross, so each (walker, field) integral splits its z range
        # there into two Gauss-Legendre panels
        roots = fleming_root_logf(logf50, alpha_c[:, None], min_comp_frac,
                                  layout.fcmin, iters=50)         # (W, F)
        zstar = torch.clamp(ctx.cosmo.z_at_log10_dl_cm(
            0.5 * (lum_floor - roots - LOG10_4PI)), zmin, zmax)
        z_lo = torch.stack([torch.full_like(zstar, 1.0) * zmin, zstar], 1)
        z_hi = torch.stack([zstar, torch.full_like(zstar, 1.0) * zmax], 1)
        zspan = (z_hi - z_lo)[..., None]                 # (W, 2, F, 1)
        znodes = z_lo[..., None] + u * zspan             # (W, 2, F, S)
        wz = w * zspan
        root_b = roots[:, None, :, None]
    else:
        # no completeness cut: the bound is the constant lum_floor,
        # smooth, one z panel
        znodes = (zmin + u * (zmax - zmin)).expand(1, 1, 1, n_nodes)
        wz = w * (zmax - zmin)
        root_b = None
    log_dl = ctx.cosmo.log10_dl_cm_at(znodes)
    dvdz = ctx.cosmo.differential_comoving_volume(znodes)
    if root_b is None:
        minlum = torch.full_like(log_dl, lum_floor)
    else:
        minlum = torch.clamp(root_b + LOG10_4PI + 2.0 * log_dl,
                             min=lum_floor)                  # (W, 2, F, S)
    span = lh - minlum
    logL = minlum[..., None, :] + u[:, None] * span[..., None, :]
    wl = w[:, None] * span[..., None, :]                     # (.., S, S)
    logf = logL - LOG10_4PI - 2.0 * log_dl[..., None, :]
    om = omega_from_logf(logf, ctx.omega0_f[:, None, None],
                         logf50[:, None, :, None, None],
                         alpha_c[wb], layout.fcmin)
    lnphi = log_true_lum_func(logL, sch_al[wb], lstar[wb], phistar[wb])
    integrand = torch.exp(lnphi) * om * wl * (wz * dvdz)[..., None, :]
    return lnpart, integrand.reshape(theta.shape[0], -1).sum(dim=1)


def lnlike_exact_bounds(theta, ctx: LFContext, layout: ThetaLayout,
                        min_comp_frac: float, lum_floor: float, lh: float,
                        n_nodes: int = 32):
    """Free-completeness lnL with theta-exact integration bounds.

    The reference freezes the logL grid's lower bound at the build-time
    completeness parameters even while sampling Flim/alpha_c (its
    exact-bounds routine is dead code). Here the bound

        minlum_f(z | theta) = max(log10(4 pi dL^2 root_f(theta)), lum_floor)

    is re-derived per evaluation (the root by :func:`fleming_root_logf`,
    differentiable), and the (L, z) integral taken by Gauss-Legendre on
    ``n_nodes`` x ``n_nodes`` nodes mapped through the theta-dependent
    bounds. (W, D) -> (W,).
    """
    lnpart, fullint = lnlike_exact_bounds_parts(
        theta, ctx, layout, min_comp_frac, lum_floor, lh, n_nodes)
    return lnpart - fullint


def make_lnprob(ctx: LFContext, layout: ThetaLayout, collapse: bool = True,
                exact_bounds: bool = False, min_comp_frac: float = 0.5,
                lh: float = 46.0):
    """Build the batched lnprob, (W, D) -> (W,).

    The likelihood is always evaluated and masked by the prior; box
    bounds are finite, so out-of-box thetas never leak NaN into the
    result. ``exact_bounds`` (free completeness only) takes
    :func:`lnlike_exact_bounds` with the catalog's faintest luminosity
    as the floor.
    """
    if exact_bounds and layout.fix_comp:
        raise ValueError("exact_bounds applies to free completeness only")
    lum_floor = float(ctx.lum.min()) if exact_bounds else None

    # bounds made once: a host tensor per call would sync the device
    lo, hi = layout.bounds_arrays(ctx.lum.dtype, ctx.lum.device)

    def lnprob(theta):
        if exact_bounds:
            lnl = lnlike_exact_bounds(theta, ctx, layout, min_comp_frac,
                                      lum_floor, lh)
        else:
            lnl = lnlike_single_epoch(theta, ctx, layout,
                                      collapse=collapse)
        return torch.where(in_box(theta, lo, hi), lnl,
                           torch.full_like(lnl, NEG_INF))

    return lnprob


def sample_init(generator: torch.Generator, layout: ThetaLayout,
                nwalkers: int, diff_rand: bool = True,
                dtype=torch.float64, device="cpu"):
    """Uniform walker starts inside the prior box, including the
    reference's ``diff_rand=False`` mode that reuses one U(0,1) draw per
    walker across all dimensions."""
    lo, hi = layout.bounds_arrays(dtype, device)
    ncol = layout.ndim if diff_rand else 1
    u = torch.rand((nwalkers, ncol), generator=generator, dtype=dtype,
                   device=device)
    return u * (hi - lo) + lo
