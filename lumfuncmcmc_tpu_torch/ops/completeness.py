"""Fleming completeness curve and its faint-end modification (port of
``lumfuncmcmc_tpu/ops/completeness.py``).

With ``x = alpha * (logf - logF50)``::

    fc      = 0.5 * (1 + x / sqrt(1 + x^2))
    f_tau   : flux where fc = fcmin  (closed form)
    fc_mod  = fc ** ( 1 / (1 - exp(-f/f_tau)) )

The likelihood works in log flux (:func:`fleming_from_logf`);
:func:`fleming`, :func:`inverse_fleming` and :func:`p_curve` are the
reference's linear-flux forms. The float64 numpy forms used by the host
precompute, and :func:`min_flux_p_curve`, are carried over unchanged.
:func:`fleming_root_logf` is the in-graph bisection the exact-bounds
likelihood takes, with the implicit-function derivative.
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
    bright side for fcmin > 0.5. ``alpha`` is a tensor or a float,
    ``fcmin`` a float in (0, 1)."""
    sign, a = _fleming_ratio_constants(fcmin)
    sqrt = torch.sqrt if isinstance(alpha, torch.Tensor) else math.sqrt
    return sign * sqrt(a / alpha**2)


def _fleming_ratio_constants(fcmin):
    """``(sign, A)`` of :func:`_log10_inverse_fleming_ratio`, which is
    ``sign * sqrt(A / alpha**2)``: the sign of ``2 fcmin - 1`` and
    ``|a / (1 - a)|``, ``a = (2 fcmin - 1)^2`` (``csrc/free_feats.cu``
    takes them from here)."""
    s = 2.0 * fcmin - 1.0
    a = s * s
    return float((s > 0) - (s < 0)), abs(a / (1.0 - a))


def inverse_fleming(f50, alpha, fcmin=0.1):
    """Flux where the unmodified Fleming completeness equals fcmin.
    Tensors or floats; a float pair gives a float."""
    return f50 * 10.0 ** _log10_inverse_fleming_ratio(alpha, fcmin)


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


def fleming(f, Flim=3.0e-17, alpha=3.5, fcmin=0.1):
    """Modified Fleming completeness of the linear fluxes ``f`` (a
    tensor), on its device and in its dtype. As in the reference,
    ``alpha=None`` means fully complete and a falsy ``fcmin`` drops the
    faint-end modification. :func:`fleming_from_logf` is the form the
    likelihood uses."""
    if alpha is None:
        return torch.ones_like(f)
    logF50 = (torch.log10(Flim) if isinstance(Flim, torch.Tensor)
              else math.log10(Flim))
    return fleming_from_logf(torch.log10(f), logF50, alpha, fcmin)


def p_curve(F, Flim=3.0e-17, alpha=-3.5):
    """The reference's older completeness curve with the 2.5x slope
    (its ``get_min_flux`` uses it), on the tensor ``F``."""
    x = 2.5 * alpha * torch.log10(F / Flim)
    return 0.5 * (1.0 - x / torch.sqrt(1.0 + x * x))


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


def min_flux_p_curve(min_comp_frac, Flim, alpha, iters=80):
    """Flux where :func:`p_curve` reaches ``min_comp_frac``: a host
    float64 bisection in log flux (the curve is increasing in F for
    alpha < 0, the reference's usage); 0 for ``min_comp_frac`` ~ 0, as
    the reference's ``get_min_flux`` returns."""
    if abs(min_comp_frac) < 1.0e-6:
        return 0.0
    lo, hi = np.log10(Flim) - 6.0, np.log10(Flim) + 6.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        x = 2.5 * alpha * (mid - np.log10(Flim))
        val = 0.5 * (1.0 - x / np.sqrt(1.0 + x * x))
        if (val < min_comp_frac) == (alpha < 0):
            lo = mid
        else:
            hi = mid
    return 10.0 ** (0.5 * (lo + hi))


class _FlemingRoot(torch.autograd.Function):
    """Bisection root of ``fleming_from_logf(r, logF50, alpha) = mcf`` with
    the implicit-function derivative: ``dr = -(F_logF50 dlogF50 + F_alpha
    dalpha) / F_r``. A raw bisection's gradient flows only through its
    comparisons and comes out zero, which would drop the completeness
    boundary's term from NUTS trajectories."""

    @staticmethod
    def forward(ctx, logF50, alpha, min_comp_frac, fcmin, iters):
        lo, hi = logF50 - 6.0, logF50 + 6.0
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            go_right = fleming_from_logf(mid, logF50, alpha,
                                         fcmin) < min_comp_frac
            lo = torch.where(go_right, mid, lo)
            hi = torch.where(go_right, hi, mid)
        root = 0.5 * (lo + hi)
        ctx.save_for_backward(logF50, alpha, root)
        ctx.fcmin = fcmin
        return root

    @staticmethod
    def backward(ctx, grad):
        # the saved root comes back attached to this node, so under
        # create_graph a second derivative goes through the same rule
        logF50, alpha, root = ctx.saved_tensors
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            r, f, a = torch.broadcast_tensors(root, logF50, alpha)
            # partials of F at (r, f, a) as functions of them: the
            # gradient of F(r + e0, f + e1, a + e2) at e = 0
            e = torch.zeros((3,) + tuple(r.shape), dtype=r.dtype,
                            device=r.device, requires_grad=True)
            val = fleming_from_logf(r + e[0], f + e[1], a + e[2],
                                    ctx.fcmin)
            (d,) = torch.autograd.grad(val.sum(), e, create_graph=create)
        g = grad / d[0]
        return ((-g * d[1]).sum_to_size(logF50.shape),
                (-g * d[2]).sum_to_size(alpha.shape), None, None, None)


def fleming_root_logf(logF50, alpha, min_comp_frac, fcmin=0.1, iters=80):
    """log10 of the flux where the modified Fleming curve crosses
    ``min_comp_frac``: a fixed-count bisection on the monotone curve over
    a 12-dex bracket, elementwise over broadcast (logF50, alpha)
    tensors, differentiable in both by the implicit-function theorem
    (:class:`_FlemingRoot`)."""
    return _FlemingRoot.apply(logF50, alpha, float(min_comp_frac), fcmin,
                              int(iters))
