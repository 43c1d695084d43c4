"""Schechter luminosity-function forms (port of
``lumfuncmcmc_tpu/ops/schechter.py``: the single-epoch subset)."""

from __future__ import annotations

import math

import torch

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
