"""Fixed-order quadrature rules (port of
``lumfuncmcmc_tpu/ops/quadrature.py``): trapezoid weights and
Gauss–Legendre nodes, computed on the host in float64 and put on the
device the caller names."""

from __future__ import annotations

import numpy as np
import torch


def trapz_weights(n: int, *, dtype=torch.float64, device):
    """Trapezoid endpoint weights for n uniformly-spaced samples:
    integral = dx * sum(w * f) with w = [0.5, 1, ..., 1, 0.5]."""
    w = np.ones(n)
    w[0] = w[-1] = 0.5
    return torch.tensor(w, dtype=dtype, device=device)


def gauss_legendre(n: int, a=0.0, b=1.0, *, dtype=torch.float64, device):
    """Gauss–Legendre nodes and weights on [a, b]."""
    x, w = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (x + 1.0) * (b - a) + a
    w = 0.5 * (b - a) * w
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(w, dtype=dtype, device=device))


def gl_nodes_unit(n: int):
    """Gauss–Legendre nodes/weights on [0, 1] as float64 numpy."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def integrate_gl_unit(f, n: int, lo, hi):
    """∫_lo^hi f(x) dx via the u∈[0,1] change of variables. ``lo``/``hi``
    are tensors (broadcast against the node axis, appended last)."""
    lo = torch.as_tensor(lo)
    hi = torch.as_tensor(hi, dtype=lo.dtype, device=lo.device)
    u, w = gl_nodes_unit(n)
    u = torch.as_tensor(u, dtype=lo.dtype, device=lo.device)
    w = torch.as_tensor(w, dtype=lo.dtype, device=lo.device)
    x = lo[..., None] + u * (hi - lo)[..., None]
    return torch.sum(f(x) * w, dim=-1) * (hi - lo)
