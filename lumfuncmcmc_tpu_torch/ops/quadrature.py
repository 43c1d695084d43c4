"""Fixed-order Gauss–Legendre quadrature (port of the part of
``lumfuncmcmc_tpu/ops/quadrature.py`` that ``models/veff.py`` uses)."""

from __future__ import annotations

import numpy as np
import torch


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
