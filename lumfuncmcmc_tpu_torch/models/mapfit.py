"""MAP point estimate + Laplace approximation (port of
``lumfuncmcmc_tpu/models/mapfit.py``).

A multi-start BFGS in the sigmoid box map gives the posterior mode, and
the Hessian at the mode gives the Laplace covariance ``-H^{-1}`` and a
marginal-likelihood estimate

    ln Z ~ lnpost(MAP) + d/2 ln 2pi - 1/2 ln det(-H) + ln pi_norm

that cross-checks the tempered ladder. All starts run as one batched
float64 BFGS on the lnpost's device (:func:`bfgs_minimize`); the
gradient is autograd of the eager lnpost and the Hessian its double
backward (the value+gradient kernels have no second derivative).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

LS_HALVINGS = 30      # step halvings a line search tries before it fails


def _value_grad(fun: Callable, x):
    """Row values and row gradients of ``fun`` (B, d) -> (B,), whose rows
    are independent (the gradient of the sum is each row's own)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        f = fun(x)
        (g,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), g.detach()


def bfgs_minimize(fun: Callable, x0, maxiter: int = 500, gtol: float = 1e-5):
    """Minimize each row of ``fun`` (B, d) -> (B,) from ``x0`` (B, d), all
    rows in one batch: BFGS (Nocedal & Wright, Algorithm 6.1) from the
    identity inverse Hessian, with a backtracking Armijo line search
    (c1 = 1e-4, step halved up to ``LS_HALVINGS`` times) and the
    inverse-Hessian update taken where ``y.s > 0``. A row converges when
    its gradient's largest entry falls below ``gtol`` (the JAX BFGS's
    rule) and fails when its line search finds no decrease.

    Returns ``(x (B, d), f (B,), success (B,) bool)``.
    """
    x = x0.detach().clone()
    B, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device).expand(B, d, d)
    f, g = _value_grad(fun, x)
    H = eye.clone()
    conv = g.abs().amax(dim=1) < gtol
    failed = ~torch.isfinite(f)
    for _ in range(int(maxiter)):
        active = ~(conv | failed)
        if not bool(active.any()):
            break
        p = -(H @ g[..., None])[..., 0]
        slope = (g * p).sum(dim=1)
        uphill = slope >= 0            # not a descent direction: reset
        p = torch.where(uphill[:, None], -g, p)
        H = torch.where(uphill[:, None, None], eye, H)
        slope = (g * p).sum(dim=1)
        alpha = torch.ones_like(f)
        found = torch.zeros_like(active)
        xn, fn, gn = x, f, g
        for _ in range(LS_HALVINGS):
            trial = active & ~found
            if not bool(trial.any()):
                break
            xt = x + alpha[:, None] * p
            ft, gt = _value_grad(fun, xt)
            ok = (trial & torch.isfinite(ft)
                  & (ft <= f + 1e-4 * alpha * slope))
            xn = torch.where(ok[:, None], xt, xn)
            fn = torch.where(ok, ft, fn)
            gn = torch.where(ok[:, None], gt, gn)
            found = found | ok
            alpha = torch.where(trial & ~ok, 0.5 * alpha, alpha)
        failed = failed | (active & ~found)
        step = active & found
        s, y = xn - x, gn - g
        ys = (y * s).sum(dim=1)
        rho = 1.0 / ys
        upd = step & (ys > 0) & torch.isfinite(rho)
        w = eye - rho[:, None, None] * s[:, :, None] * y[:, None, :]
        h_new = (w @ H @ w.transpose(1, 2)
                 + rho[:, None, None] * s[:, :, None] * s[:, None, :])
        H = torch.where(upd[:, None, None], h_new, H)
        x = torch.where(step[:, None], xn, x)
        f = torch.where(step, fn, f)
        g = torch.where(step[:, None], gn, g)
        conv = conv | (step & (g.abs().amax(dim=1) < gtol))
    return x, f, conv


def _edge_slice_lnmass(lnpost, th, lnpost_map, i, lo_np, hi_np, dtype,
                       device, n_halvings: int = 24, n_gl: int = 8):
    """ln of the 1-D mass of the posterior slice along pinned axis ``i``
    from the box edge the MAP sits on into the box, ``ln int_0^W
    exp(lnpost(theta* + t e) - lnpost(theta*)) dt``: geometric panels
    ``[W 2^{-k-1}, W 2^{-k}]`` down to ``W 2^{-24}``, Gauss-Legendre 8
    per panel, all nodes in one batched lnpost call."""
    w = float(hi_np[i] - lo_np[i])
    at_lo = (th[i] - lo_np[i]) < (hi_np[i] - th[i])
    sign = 1.0 if at_lo else -1.0
    xg, wg = np.polynomial.legendre.leggauss(int(n_gl))
    ts, ws = [], []
    for k in range(int(n_halvings)):
        p1 = w * 2.0 ** (-k)
        p0 = 0.0 if k == int(n_halvings) - 1 else w * 2.0 ** (-k - 1)
        ts.append(0.5 * (p1 + p0) + 0.5 * (p1 - p0) * xg)
        ws.append(0.5 * (p1 - p0) * wg)
    ts = np.concatenate(ts)
    ws = np.concatenate(ws)
    pts = np.repeat(th[None, :], ts.size, axis=0)
    pts[:, i] = th[i] + sign * ts
    with torch.no_grad():
        vals = lnpost(torch.as_tensor(pts, dtype=dtype, device=device))
    vals = vals.double().cpu().numpy() - lnpost_map
    vals = np.where(np.isfinite(vals), vals, -np.inf)
    return float(np.log(np.dot(ws, np.exp(np.minimum(vals, 0.0)))))


def _hessian(lnpost, theta):
    """Gradient and Hessian of the scalar ``lnpost`` at ``theta`` (d,) by
    double backward."""
    th = theta.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        f = lnpost(th[None])[0]
        (g,) = torch.autograd.grad(f, th, create_graph=True)
        rows = [torch.autograd.grad(g[i], th, retain_graph=True)[0]
                for i in range(th.shape[0])]
    return g.detach(), torch.stack(rows).detach()


def laplace_fit(lnpost: Callable, lo, hi, generator=None, nstarts: int = 8,
                maxiter: int = 500, gtol: float = 1e-6, restarts: int = 3):
    """Maximize the batched ``lnpost`` (B, d) -> (B,) over the box ``[lo,
    hi]`` (float64 tensors on its device) and Laplace-expand.

    ``theta = lo + (hi-lo) sigmoid(y)`` removes the box and BFGS runs on
    ``-lnpost(theta(y)) / sc`` (no Jacobian term: the theta-space mode),
    ``sc = max(1, |lnpost|)`` at each start, from ``nstarts``
    center-shrunk uniform starts (``generator``), ``restarts`` times
    from the best point so far, keeping a restart only where it
    improves. Returns the JAX function's dict: ``theta``, ``lnpost``,
    ``grad_norm``, ``cov``/``se`` (NaN on ``boundary`` axes, None
    without a negative definite interior block), ``ln_int`` (Gaussian
    over the free axes times each pinned axis' slice integral),
    ``hess_eigvals``, ``hess_ok``, ``boundary``, ``converged``,
    ``n_finite``, ``nstarts``.
    """
    lo = torch.as_tensor(lo, dtype=torch.float64)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=lo.device)
    d = int(lo.shape[0])
    dev = lo.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    span = hi - lo

    def to_theta(y):
        return lo + span * torch.sigmoid(y)

    def to_y(theta):
        p = torch.clamp((theta - lo) / span, 1e-6, 1.0 - 1e-6)
        return torch.log(p) - torch.log1p(-p)

    u = torch.rand((nstarts, d), generator=generator, dtype=torch.float64,
                   device=dev)
    mid = (lo + hi) / 2.0
    y = to_y(0.8 * mid[None, :] + 0.2 * (lo[None, :] + u * span[None, :]))
    with torch.no_grad():
        sc = torch.clamp(lnpost(to_theta(y)).abs(), min=1.0)
    # a NaN scale (lnpost NaN at the start) keeps the row's objective NaN
    sc = torch.where(torch.isfinite(sc), sc, torch.full_like(sc, math.nan))

    def obj(yy):
        return -lnpost(to_theta(yy)) / sc

    ff = torch.full_like(sc, math.inf)
    ok = torch.zeros(nstarts, dtype=torch.bool, device=dev)
    for _ in range(max(int(restarts), 1)):
        yr, fr, sr = bfgs_minimize(obj, y, maxiter=maxiter, gtol=gtol)
        better = fr < ff
        y = torch.where(better[:, None], yr, y)
        ff = torch.where(better, fr, ff)
        ok = torch.where(better, sr, ok)
    funs = (ff * sc).cpu().numpy()
    funs_rank = np.where(np.isfinite(funs), funs, np.inf)
    n_finite = int(np.isfinite(funs).sum())
    if n_finite == 0:
        raise RuntimeError(
            "laplace_fit: no start converged to a finite optimum — the "
            "posterior may have no interior mode in the box")
    best = int(np.argmin(funs_rank))
    theta = to_theta(y[best])
    _, g_y = _value_grad(lambda yy: -lnpost(to_theta(yy)), y[best:best + 1])
    sc_best = float(sc[best])
    converged = bool(ok[best]) or bool(
        float(g_y.abs().max()) / sc_best <= 10.0 * gtol)

    g, H = _hessian(lnpost, theta)
    negH = (-0.5 * (H + H.T)).cpu().numpy()
    th = theta.detach().cpu().numpy()
    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    span_np = hi_np - lo_np
    # a posterior monotone toward a box edge pins the MAP there: profile
    # the pinned axes out and keep the interior block's errors
    boundary = ((th - lo_np < 1e-4 * span_np)
                | (hi_np - th < 1e-4 * span_np))
    free = ~boundary
    sub = negH[np.ix_(free, free)]
    eigval, eigvec = (np.linalg.eigh(sub) if free.any()
                      else (np.empty(0), np.empty((0, 0))))
    hess_ok = bool(free.any() and np.all(eigval > 0)
                   and np.all(np.isfinite(eigval)))
    with torch.no_grad():
        lnpost_map = float(lnpost(theta[None])[0])
    if hess_ok:
        cov_sub = (eigvec / eigval) @ eigvec.T
        cov = np.full((d, d), np.nan)
        cov[np.ix_(free, free)] = cov_sub
        se = np.full(d, np.nan)
        se[free] = np.sqrt(np.diag(cov_sub))
        d_f = int(free.sum())
        ln_int = (lnpost_map + 0.5 * d_f * math.log(2.0 * math.pi)
                  - 0.5 * float(np.sum(np.log(eigval))))
        for i in np.nonzero(boundary)[0]:
            ln_int += _edge_slice_lnmass(lnpost, th, lnpost_map, int(i),
                                         lo_np, hi_np, torch.float64, dev)
    else:
        cov = se = ln_int = None
    return {
        "theta": th,
        "lnpost": lnpost_map,
        "grad_norm": float(torch.linalg.norm(g)),
        "cov": cov,
        "se": se,
        "ln_int": ln_int,
        "hess_eigvals": np.asarray(eigval, dtype=np.float64),
        "hess_ok": hess_ok,
        "boundary": boundary,
        "converged": converged,
        "n_finite": n_finite,
        "nstarts": int(nstarts),
    }
