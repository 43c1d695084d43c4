"""Hierarchical multi-field joint Schechter fit: the eager engine (port
of ``lumfuncmcmc_tpu/models/hierarchical.py``).

Every field gets its own (logL*_f, logphi*_f), drawn from Gaussian
population hyperpriors, while the faint-end slope is shared::

    theta = [mu_L, sig_L, mu_p, sig_p, (sch_al),
             Lstar_0..Lstar_{F-1}, phistar_0..phistar_{F-1}]

    lnpost = sum_f [ lnpart_f(Lstar_f, phistar_f, sch_al)
                     - integral_f(Lstar_f, phistar_f, sch_al) ]
           + sum_f [ ln N(Lstar_f | mu_L, sig_L)
                     + ln N(phistar_f | mu_p, sig_p) ]
           + box prior

Completeness is fixed, so the per-field ln-terms take the exact O(1)
collapsed form from the per-field catalog scalars of
:class:`~lumfuncmcmc_tpu_torch.models.context.LFContext` and the only
O(grid) work is the per-field integral over the frozen ``w_fixed`` grid.

As in :mod:`~lumfuncmcmc_tpu_torch.models.likelihood`, every function
takes a batch of thetas, (W, D), and returns (W,). The hand-kernel
engine is :func:`lumfuncmcmc_tpu_torch.ops.cuda_lnlike.make_cuda_lnprob_h`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.models.context import LFContext
from lumfuncmcmc_tpu_torch.models.likelihood import in_box, lnprior
from lumfuncmcmc_tpu_torch.ops.schechter import (
    LN10, _LOG_LN10, log_true_lum_func)

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class ThetaLayoutH:
    """Static description of the hierarchical parameter vector."""

    names: tuple
    lo: tuple
    hi: tuple
    nfields: int
    fix_sch_al: bool
    sch_al0: float

    @property
    def ndim(self) -> int:
        return len(self.names)

    @classmethod
    def from_config(cls, cfg: LFConfig) -> "ThetaLayoutH":
        nf = len(cfg.Flim)
        names = ["mu_L", "sig_L", "mu_p", "sig_p"]
        lo = [cfg.Lstar_lims[0], 0.01, cfg.phistar_lims[0], 0.01]
        hi = [cfg.Lstar_lims[1], 2.0, cfg.phistar_lims[1], 3.0]
        if not cfg.fix_sch_al:
            names.append("sch_al")
            lo.append(cfg.sch_al_lims[0]); hi.append(cfg.sch_al_lims[1])
        for i in range(nf):
            names.append(f"Lstar_{i}")
            lo.append(cfg.Lstar_lims[0]); hi.append(cfg.Lstar_lims[1])
        for i in range(nf):
            names.append(f"phistar_{i}")
            lo.append(cfg.phistar_lims[0]); hi.append(cfg.phistar_lims[1])
        return cls(names=tuple(names), lo=tuple(lo), hi=tuple(hi),
                   nfields=nf, fix_sch_al=cfg.fix_sch_al,
                   sch_al0=cfg.sch_al)

    def plot_names(self):
        """LaTeX labels in theta order."""
        out = [r"$\mu_{L_*}$", r"$\sigma_{L_*}$", r"$\mu_{\phi_*}$",
               r"$\sigma_{\phi_*}$"]
        if not self.fix_sch_al:
            out.append(r"$\alpha$")
        out += [r"$\log L_{*,%d}$" % i for i in range(self.nfields)]
        out += [r"$\log \phi_{*,%d}$" % i for i in range(self.nfields)]
        return out

    def unpack(self, theta):
        """(W, D) thetas -> (mu_L, sig_L, mu_p, sig_p, sch_al), each
        (W,), and (Lstar_f, phistar_f), each (W, F)."""
        mu_l, sig_l, mu_p, sig_p = (theta[:, i] for i in range(4))
        k = 4
        if self.fix_sch_al:
            sch_al = torch.full_like(mu_l, self.sch_al0)
        else:
            sch_al = theta[:, k]; k += 1
        nf = self.nfields
        return (mu_l, sig_l, mu_p, sig_p, sch_al, theta[:, k:k + nf],
                theta[:, k + nf:k + 2 * nf])

    def bounds_arrays(self, dtype, device):
        return (torch.tensor(self.lo, dtype=dtype, device=device),
                torch.tensor(self.hi, dtype=dtype, device=device))


def _ln_normal(x, mu, sig):
    return -0.5 * (((x - mu) / sig) ** 2 + _LOG_2PI) - torch.log(sig)


def lnprior_h(theta, layout: ThetaLayoutH):
    """Uniform box prior, inclusive bounds: the single-epoch model's
    masking rule (``likelihood.lnprior`` takes any layout with
    ``bounds_arrays``). (W, D) -> (W,)."""
    return lnprior(theta, layout)


def lnlike_h_split(theta, ctx: LFContext, layout: ThetaLayoutH):
    """``(data, hyper)``, each (W,): the per-field Poisson point-process
    terms and the population-hyperprior terms (the hyperprior belongs to
    the prior measure, so a tempered run tempers only ``data``)."""
    mu_l, sig_l, mu_p, sig_p, sch_al, lstar_f, phistar_f = \
        layout.unpack(theta)
    # per-field collapsed ln-terms (exact; see likelihood.py)
    lnpart_f = (ctx.nsrc_f * (_LOG_LN10 + LN10 * phistar_f)
                + LN10 * (sch_al[:, None] + 1.0)
                * (ctx.sum_lum_f - ctx.nsrc_f * lstar_f)
                - torch.exp(LN10 * (ctx.lref - lstar_f)) * ctx.sum_pow_lum_f
                + ctx.sum_ln_om_f)
    # per-field grid integrals: phi_f on field f's frozen grid
    lnphi_grid = log_true_lum_func(
        ctx.logL_grid, sch_al[:, None, None, None],
        lstar_f[:, :, None, None], phistar_f[:, :, None, None])
    int_f = (torch.exp(lnphi_grid) * ctx.w_fixed).sum(dim=(2, 3))
    hyper = (_ln_normal(lstar_f, mu_l[:, None], sig_l[:, None]).sum(dim=1)
             + _ln_normal(phistar_f, mu_p[:, None],
                          sig_p[:, None]).sum(dim=1))
    return (lnpart_f - int_f).sum(dim=1), hyper


def lnlike_h(theta, ctx: LFContext, layout: ThetaLayoutH):
    """Joint likelihood with per-field (L*, phi*) and a shared alpha.
    (W, D) -> (W,)."""
    data, hyper = lnlike_h_split(theta, ctx, layout)
    return data + hyper


def make_lnprob_h(ctx: LFContext, layout: ThetaLayoutH):
    """Build the batched lnprob, (W, D) -> (W,): the likelihood is always
    evaluated, at theta clamped into the box, and masked by the box
    prior: an out-of-box row (a ``sig <= 0`` among them) gives -inf and
    a gradient of exactly 0."""
    # bounds made once: a host tensor per call would sync the device
    lo, hi = layout.bounds_arrays(ctx.lum.dtype, ctx.lum.device)

    def lnprob(theta):
        lnl = lnlike_h(torch.clamp(theta, lo, hi), ctx, layout)
        return torch.where(in_box(theta, lo, hi), lnl,
                           torch.full_like(lnl, -math.inf))

    return lnprob


def _gauss_cdf(x):
    erf = np.vectorize(math.erf, otypes=[np.float64])
    return 0.5 * (1.0 + erf(np.asarray(x, np.float64) / math.sqrt(2.0)))


def _box_mass_integral(m0, m1, s0, s1, a, b, F, n_mu=32, n_sig=48):
    """``I = int_{m0}^{m1} dmu int_{s0}^{s1} dsig G(mu, sig)^F`` with
    ``G = Phi((b-mu)/sig) - Phi((a-mu)/sig)``: the total mass the
    box-truncated Gaussian hyperprior block contributes to the prior
    normalization (F fields share one (mu, sig); [a, b] is the field
    parameter box, [m0, m1] x [s0, s1] the hyper box).

    Split-panel Gauss-Legendre: G is analytic in sigma, but in mu it has
    erf boundary layers of width ~sigma around the field-box edges, so
    for each sigma node the mu integral runs over panels split at
    ``a +- 10 sigma`` / ``b +- 10 sigma`` (clipped to the hyper box).
    """
    xg, wg = np.polynomial.legendre.leggauss(int(n_mu))
    xs, ws = np.polynomial.legendre.leggauss(int(n_sig))

    def g_pow(mu, sig):
        return (_gauss_cdf((b - mu) / sig)
                - _gauss_cdf((a - mu) / sig)) ** F

    total = 0.0
    for t, w_s in zip(xs, ws):
        sig = 0.5 * (s1 + s0) + 0.5 * (s1 - s0) * t
        w_sig = 0.5 * (s1 - s0) * w_s
        cuts = sorted({m0, m1,
                       *(min(max(c, m0), m1)
                         for c in (a - 10.0 * sig, a + 10.0 * sig,
                                   b - 10.0 * sig, b + 10.0 * sig))})
        acc = 0.0
        for p0, p1 in zip(cuts[:-1], cuts[1:]):
            if p1 <= p0:
                continue
            mu = 0.5 * (p1 + p0) + 0.5 * (p1 - p0) * xg
            acc += 0.5 * (p1 - p0) * float(np.dot(wg, g_pow(mu, sig)))
        total += w_sig * acc
    return total


def lnz0_prior(layout: ThetaLayoutH, n_mu=32, n_sig=48):
    """ln of the hierarchical prior normalization
    ``Z0 = int_box dtheta prod_f N(Lstar_f|mu_L,sig_L)
    N(phistar_f|mu_p,sig_p)`` (host-side numpy, float64).

    The integral factorizes: sch_al (when free) is an independent
    uniform (width factor); the (mu_L, sig_L) x {Lstar_f} and
    (mu_p, sig_p) x {phistar_f} blocks each reduce to the 2-D
    erf-product integral of :func:`_box_mass_integral`, because every
    field shares the hyper-mean's own box.
    """
    F = layout.nfields
    lo = np.asarray(layout.lo, np.float64)
    hi = np.asarray(layout.hi, np.float64)
    kf = 4 + (0 if layout.fix_sch_al else 1)
    i_l = _box_mass_integral(lo[0], hi[0], lo[1], hi[1],
                             lo[kf], hi[kf], F, n_mu=n_mu, n_sig=n_sig)
    i_p = _box_mass_integral(lo[2], hi[2], lo[3], hi[3],
                             lo[kf + F], hi[kf + F], F,
                             n_mu=n_mu, n_sig=n_sig)
    out = float(np.log(i_l) + np.log(i_p))
    if not layout.fix_sch_al:
        out += float(np.log(hi[4] - lo[4]))
    return out
