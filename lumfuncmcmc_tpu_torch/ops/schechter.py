"""Schechter luminosity-function forms (port of
``lumfuncmcmc_tpu/ops/schechter.py``: the single-epoch forms, the four
parameterizations the V_eff Schechter fit takes, and the
redshift-evolving ones)."""

from __future__ import annotations

import math

import torch

from lumfuncmcmc_tpu_torch.ops.gamma import upper_gamma

LN10 = 2.302585092994046
_LOG_LN10 = math.log(LN10)


def log_true_lum_func(logL, alpha, logLstar, logphistar):
    """ln of the log-space Schechter function phi(logL) [Mpc^-3 dex^-1].

    ln phi = ln(ln 10) + ln10*logphistar + ln10*(logL-logLstar)*(alpha+1)
             - 10^(logL-logLstar)
    """
    x = logL - logLstar
    return (_LOG_LN10 + LN10 * logphistar + LN10 * x * (alpha + 1.0)
            - torch.exp(LN10 * x))


def true_lum_func(logL, alpha, logLstar, logphistar):
    """Schechter phi(logL) in Mpc^-3 dex^-1."""
    return torch.exp(log_true_lum_func(logL, alpha, logLstar, logphistar))


def schechter(L, al, phistar, Lstar):
    """Linear-space Schechter dn/d(L/L*)."""
    x = L / Lstar
    return phistar * x**al * torch.exp(-x)


def schechter_log(L, al, phistar, Lstar):
    """Log-space Schechter with log10 parameters."""
    return true_lum_func(L, al, Lstar, phistar)


def schechter_integ(L, al, integ, Lstar):
    """Schechter with the total integral as the amplitude parameter:
    integ = phistar * Gamma(al+1, 1e36/L*)."""
    return schechter(L, al, integ / upper_gamma(al + 1.0, 1.0e36 / Lstar),
                     Lstar)


def schechter_integ_log(L, al, integ, Lstar):
    """Log-space integral-parameterized Schechter; ``integ`` and
    ``Lstar`` are log10 quantities."""
    integ_nophi = upper_gamma(al + 1.0, 10.0 ** (36.0 - Lstar))
    return schechter_log(L, al, integ - torch.log10(integ_nophi), Lstar)


def quad_coef(y1, y2, y3, z1, z2, z3):
    """Quadratic coefficients through three pivots (Leja et al. 2020
    style): y = a z^2 + b z + c."""
    a = ((y3 - y1) + (y2 - y1) * (z1 - z3) / (z2 - z1)) / (
        z3**2 - z1**2 + (z2**2 - z1**2) * (z1 - z3) / (z2 - z1))
    b = (y2 - y1 - a * (z2**2 - z1**2)) / (z2 - z1)
    c = y1 - a * z1**2 - b * z1
    return a, b, c


def log_schechter_z(logL, z, al, L1, L2, L3, phi1, phi2, phi3, z1, z2, z3):
    """ln phi(logL, z) with (logL*, logphi*) quadratic in z through three
    pivot values; ``logL``, ``z`` and the parameters broadcast."""
    aphi, bphi, cphi = quad_coef(phi1, phi2, phi3, z1, z2, z3)
    alum, blum, clum = quad_coef(L1, L2, L3, z1, z2, z3)
    phistar = aphi * z**2 + bphi * z + cphi
    lstar = alum * z**2 + blum * z + clum
    return log_true_lum_func(logL, al, lstar, phistar)


def schechter_z(logL, z, al, L1, L2, L3, phi1, phi2, phi3, z1, z2, z3):
    """phi(logL, z) for the redshift-evolving model."""
    return torch.exp(log_schechter_z(logL, z, al, L1, L2, L3,
                                     phi1, phi2, phi3, z1, z2, z3))
