"""Upper incomplete gamma Gamma(a, x) for real a, a <= 0 included (port
of ``lumfuncmcmc_tpu/ops/gamma.py``).

The integral-parameterized Schechter forms evaluate ``Gamma(al+1, x)``
with ``al+1`` anywhere in roughly [-4, 1], where the regularized
``torch.special.gammaincc`` (a > 0 only) does not apply. Negative shapes
are lifted with the recurrence

    Gamma(a, x) = ( Gamma(a+1, x) - x^a e^{-x} ) / a

a fixed number of times, then closed with ``gammaincc(a', x) *
Gamma(a')`` at a' > 0. ``torch.special.gammaincc`` has no derivative in
``a``: callers that need one difference the function numerically
(:mod:`lumfuncmcmc_tpu_torch.models.schfit`).
"""

from __future__ import annotations

import torch

_MAX_LIFTS = 9  # supports a > -8: shift = ceil(0.5 - a) reaches 9 for
                # a in (-8, -7.5]


def upper_gamma(a, x):
    """Gamma(a, x) = int_x^inf t^(a-1) e^(-t) dt for real a > -8, x > 0.
    ``a`` and ``x`` broadcast; the result has their common float dtype
    (float64 for Python numbers). Branch-free: always ``_MAX_LIFTS``
    recurrence steps, the ones at an already positive shape masked."""
    dtypes = [t.dtype for t in (a, x) if isinstance(t, torch.Tensor)
              and t.is_floating_point()]
    dtype = (torch.promote_types(dtypes[0], dtypes[-1]) if dtypes
             else torch.float64)
    device = next((t.device for t in (a, x)
                   if isinstance(t, torch.Tensor)), None)
    a = torch.as_tensor(a, dtype=dtype, device=device)
    x = torch.as_tensor(x, dtype=dtype, device=device)
    a, x = torch.broadcast_tensors(a, x)

    # The downward recurrence divides by a+k; near a non-positive integer
    # an intermediate shape hits 0. Gamma(a, x) is smooth in a, so such
    # shapes are nudged by eps, which balances the nudge bias (~|ln x| *
    # eps relative) against the cancellation error of the near-pole
    # recurrence step (~ulp / eps).
    eps = 1e-8 if dtype == torch.float64 else 3e-4
    near_int = (a - torch.round(a)).abs() < eps
    a = torch.where(near_int & (a < 0.5), torch.round(a) + eps, a)

    shift = torch.clamp(torch.ceil(0.5 - a), min=0.0)
    a_top = a + shift                    # >= 0.5 when lifted
    g = torch.special.gammaincc(a_top, x) * torch.exp(torch.lgamma(a_top))

    # walk back down: Gamma(a_k, x) = (Gamma(a_k + 1, x) - x^a_k e^-x) / a_k
    log_x = torch.log(x)
    for k in range(1, _MAX_LIFTS + 1):
        a_k = a_top - k
        g_next = (g - torch.exp(a_k * log_x - x)) / a_k
        g = torch.where(k <= shift, g_next, g)
    return g
