"""Omega: effective fractional survey solid angle (port of
``lumfuncmcmc_tpu/ops/omega.py``). The implied flux is formed in log
space, ``log10 f = logL - log10(4 pi) - 2 log10(dL_cm)``, which stays
exact in float32."""

from __future__ import annotations

import torch

from lumfuncmcmc_tpu_torch.cosmology import SQARCSEC_PER_SR
from lumfuncmcmc_tpu_torch.ops.completeness import fleming_from_logf

LOG10_4PI = 1.0992098640220963  # log10(4*pi)


def logflux_from_loglum(logL, log10_dl_cm):
    """log10 flux [cgs] from log10 L [erg/s] and log10 dL [cm]."""
    return logL - LOG10_4PI - 2.0 * log10_dl_cm


def loglum_from_logflux(logf, log10_dl_cm):
    """log10 L [erg/s] from log10 flux [cgs] and log10 dL [cm]."""
    return logf + LOG10_4PI + 2.0 * log10_dl_cm


def omega_from_logf(logf, omega_0, logF50, alpha, fcmin=0.1):
    """Omega given the log10 flux: survey area ``omega_0`` [arcsec^2]
    in steradians times the Fleming completeness."""
    return omega_0 / SQARCSEC_PER_SR * fleming_from_logf(
        logf, logF50, alpha, fcmin)


def omega(logL, z, cosmo, omega_0, logF50, alpha, fcmin=0.1):
    """Omega(logL, z) of the reference, exact: the implied flux from the
    cosmology table ``cosmo`` (:class:`~lumfuncmcmc_tpu_torch.cosmology.
    CosmoTable`), then :func:`omega_from_logf`."""
    logf = logflux_from_loglum(logL, cosmo.log10_dl_cm_at(z))
    return omega_from_logf(logf, omega_0, logF50, alpha, fcmin)


def lum_at_flux(F, z, cosmo):
    """Luminosity [erg/s] of the flux tensor ``F`` [cgs] at redshift
    ``z`` (the reference's ``get_L_constF``)."""
    return 10.0 ** loglum_from_logflux(torch.log10(F),
                                       cosmo.log10_dl_cm_at(z))
