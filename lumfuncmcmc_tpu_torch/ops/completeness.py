"""Fleming completeness curve and its faint-end modification (port of
``lumfuncmcmc_tpu/ops/completeness.py``).

With ``x = alpha * (logf - logF50)``::

    fc      = 0.5 * (1 + x / sqrt(1 + x^2))
    f_tau   : flux where fc = fcmin  (closed form)
    fc_mod  = fc ** ( 1 / (1 - exp(-f/f_tau)) )

The float64 numpy forms used by the host precompute are carried over
unchanged. The in-graph bisection ``fleming_root_logf`` (and its
implicit-function derivative) is not ported yet: only NUTS and the
exact-bounds likelihood use it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def expdecay(x, tau):
    """1 - exp(-x/tau)."""
    return 1.0 - torch.exp(-x / tau)


def _log10_inverse_fleming_ratio(alpha, fcmin):
    """log10(f_tau / F50) where the unmodified curve equals fcmin. The
    crossing sits on the faint side of F50 for fcmin < 0.5 and the
    bright side for fcmin > 0.5. ``alpha`` is a tensor, ``fcmin`` a
    float in (0, 1)."""
    s = 2.0 * fcmin - 1.0
    a = s * s
    sign = float((s > 0) - (s < 0))
    return sign * torch.sqrt(abs(a / (1.0 - a)) / alpha**2)


def fleming_from_logf(logf, logF50, alpha, fcmin=0.1):
    """Modified Fleming completeness fraction from log10 fluxes.

    ``fcmin`` is a Python value: falsy disables the faint-end
    modification.
    """
    x = alpha * (logf - logF50)
    fc = 0.5 * (1.0 + x / torch.sqrt(1.0 + x * x))
    if not fcmin:
        return fc
    log_ftau = logF50 + _log10_inverse_fleming_ratio(alpha, fcmin)
    # f / f_tau in log space; the exponent is clamped so exp() never
    # overflows (the decay saturates at 1 long before that)
    ratio = torch.exp(torch.clamp(
        (logf - log_ftau) * math.log(10.0), max=40.0))
    fc_decay = 1.0 - torch.exp(-ratio)
    safe_fc = torch.clamp(fc, min=1e-300 if fc.dtype == torch.float64
                          else 1e-30)
    out = torch.exp(torch.log(safe_fc) / fc_decay)
    return torch.where(fc > 0.0, out, torch.zeros_like(out))


def fleming_from_logf_np(logf, logF50, alpha, fcmin=0.1):
    """NumPy float64 form of :func:`fleming_from_logf` for host-side
    precompute (context building, synthetic catalogs)."""
    logf = np.asarray(logf, dtype=np.float64)
    x = alpha * (logf - logF50)
    fc = 0.5 * (1.0 + x / np.sqrt(1.0 + x * x))
    if not fcmin:
        return fc
    s = 2.0 * fcmin - 1.0
    a = s * s
    log_ftau = logF50 + np.sign(s) * np.sqrt(abs(a / (1.0 - a))
                                             / alpha**2)
    ratio = np.minimum((logf - log_ftau) * np.log(10.0), 40.0)
    fc_decay = 1.0 - np.exp(-np.exp(ratio))
    with np.errstate(divide="ignore"):
        out = np.where(fc > 0, np.exp(np.log(np.maximum(fc, 1e-300))
                                      / fc_decay), 0.0)
    return out


def fleming_root_logf_np(logF50, alpha, min_comp_frac, fcmin=0.1, iters=80):
    """log10 flux where the modified Fleming curve crosses
    ``min_comp_frac``: fixed-count bisection on the monotone curve,
    float64 numpy."""
    logF50 = np.asarray(logF50, dtype=np.float64)
    lo = logF50 - 6.0
    hi = logF50 + 6.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        val = fleming_from_logf_np(mid, logF50, alpha, fcmin)
        go_right = val < min_comp_frac
        lo = np.where(go_right, mid, lo)
        hi = np.where(go_right, hi, mid)
    return 0.5 * (lo + hi)
