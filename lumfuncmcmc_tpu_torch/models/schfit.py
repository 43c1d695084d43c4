"""Weighted least-squares Schechter fits to the binned V_eff LF (port of
``lumfuncmcmc_tpu/models/schfit.py``).

A self-contained Levenberg-Marquardt optimizer on the host, in float64.
All four reference parameterizations are kept (linear / log /
integral-amplitude / log-integral-amplitude), with the reference's
line-dependent alpha initialization (OIII -2.461, else -1.714), bounds,
and 1/sqrt(var) weighting. Parameter standard errors come from the
Gauss-Newton covariance (J^T W J)^-1, and
:meth:`SchechterFit.eval_uncertainty` gives the delta-method confidence
band the plots draw.

The JAX package takes its Jacobians by autodiff. Here they are central
differences: the integral-amplitude forms go through
``torch.special.gammaincc``, which has no derivative in its shape
argument, and one rule for all four forms keeps one code path. In the
scaled parameters (all O(1)) a relative step of 1e-6 leaves the Jacobian
~1e-10 from the analytic one, far inside what the optimum, ``stderr`` and
``chisqr`` are compared at.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.ops.schechter import (
    schechter, schechter_integ, schechter_integ_log, schechter_log)

_MODELS: Dict[tuple, Callable] = {
    ("lin", "phi"): schechter,
    ("log", "phi"): schechter_log,
    ("lin", "integ"): schechter_integ,
    ("log", "integ"): schechter_integ_log,
}
_FD_STEP = 1e-6     # relative central-difference step


def _jacobian(fn, x):
    """Central-difference Jacobian of ``fn`` (numpy vector -> numpy
    vector) at ``x`` -> (len(fn(x)), len(x))."""
    x = np.asarray(x, dtype=np.float64)
    cols = []
    for i in range(len(x)):
        h = _FD_STEP * max(abs(x[i]), 1e-3)
        up, dn = x.copy(), x.copy()
        up[i] += h
        dn[i] -= h
        cols.append((fn(up) - fn(dn)) / (2.0 * h))
    return np.stack(cols, axis=1)


@dataclass
class SchechterFit:
    params: dict              # name -> best-fit value
    stderr: dict              # name -> standard error
    cov: np.ndarray           # (nfree, nfree) covariance of free params
    free_names: list
    chisqr: float
    redchi: float
    success: bool
    log: bool
    integ: bool
    alpha_fixed: Optional[float]

    def best_fit(self, L):
        return _model_eval_params(self.params, L, self.log, self.integ)

    def eval_uncertainty(self, L, sigma=3.0):
        """Delta-method +-sigma band on the model curve."""
        names = self.free_names

        def f(free_vec):
            p = dict(self.params)
            p.update(zip(names, free_vec))
            return _model_eval_params(p, L, self.log, self.integ)

        jac = _jacobian(f, [self.params[nm] for nm in names])
        var = np.einsum("pi,ij,pj->p", jac, np.asarray(self.cov), jac)
        return sigma * np.sqrt(np.maximum(var, 0.0))

    def fit_report(self) -> str:
        lines = ["[[Schechter fit]]",
                 f"    chi-square         = {self.chisqr:.6g}",
                 f"    reduced chi-square = {self.redchi:.6g}",
                 f"    success            = {self.success}"]
        for nm, v in self.params.items():
            se = self.stderr.get(nm)
            fixed = " (fixed)" if nm not in self.free_names else ""
            se_s = f" +/- {se:.4g}" if se is not None else ""
            lines.append(f"    {nm:8s} = {v:.6g}{se_s}{fixed}")
        return "\n".join(lines)


def _amp_name(integ):
    return "integ" if integ else "phistar"


def _model_eval_params(p, L, log, integ):
    """The chosen Schechter form at ``L`` (array-like) -> float64
    numpy."""
    fn = _MODELS[("log" if log else "lin", "integ" if integ else "phi")]
    t = [torch.as_tensor(np.asarray(v, dtype=np.float64))
         for v in (L, p["al"], p[_amp_name(integ)], p["Lstar"])]
    return fn(*t).numpy()


def _defaults(log, integ, name, alpha_value):
    """Reference initializations and bounds."""
    if alpha_value is not None:
        al0, al_b = float(alpha_value), None
    else:
        al0 = -2.461 if name == "OIII" else -1.714
        al_b = (-5.0, 0.0)
    if not log:
        amp0, amp_b = ((0.1, (0.0, np.inf)) if integ
                       else (1.0e-3, (0.0, np.inf)))
        ls0, ls_b = 1.0e42, (1.0e40, 1.0e45)
    else:
        amp0, amp_b = ((-1.0, (-7.0, 5.0)) if integ
                       else (-3.0, (-8.0, np.inf)))
        ls0, ls_b = 42.5, (40.0, 45.0)
    return al0, al_b, amp0, amp_b, ls0, ls_b


def fit_schechter(Lavg, lfbinorig, var, name="OIII", alpha_value=None,
                  log=False, integ=False, max_iter=200) -> SchechterFit:
    """Levenberg-Marquardt fit of a Schechter form to the binned LF.

    ``alpha_value`` fixes the faint-end slope; ``log``/``integ`` select
    the parameterization; weights are 1/sqrt(var).
    """
    Lavg = np.asarray(Lavg, dtype=np.float64)
    y = np.asarray(lfbinorig, dtype=np.float64)
    w = 1.0 / np.sqrt(np.asarray(var, dtype=np.float64))

    al0, al_b, amp0, amp_b, ls0, ls_b = _defaults(log, integ, name,
                                                  alpha_value)
    amp = _amp_name(integ)
    free_names = ([amp, "Lstar"] if alpha_value is not None
                  else ["al", amp, "Lstar"])
    p0 = {"al": al0, amp: amp0, "Lstar": ls0}
    bounds = {"al": al_b or (-np.inf, np.inf), amp: amp_b, "Lstar": ls_b}

    # internal scaling so LM steps are well conditioned for linear-space
    # amplitudes (phistar ~ 1e-3, Lstar ~ 1e42)
    sc = np.array([max(abs(p0[nm]), 1e-30) for nm in free_names])
    x0 = np.array([p0[nm] for nm in free_names]) / sc
    lo = np.array([bounds[nm][0] for nm in free_names]) / sc
    hi = np.array([bounds[nm][1] for nm in free_names]) / sc

    def residual(x):
        p = dict(p0)
        p.update(zip(free_names, x * sc))
        return w * (_model_eval_params(p, Lavg, log, integ) - y)

    x = x0.copy()
    lam = 1e-3
    cost = float(np.sum(residual(x) ** 2))
    converged = False
    for _ in range(max_iter):
        r = residual(x)
        J = _jacobian(residual, x)
        JtJ = J.T @ J
        g = J.T @ r
        try:
            step = np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ))
                                   + 1e-300 * np.eye(len(x)), -g)
        except np.linalg.LinAlgError:
            lam *= 10.0
            continue
        x_new = np.clip(x + step, lo, hi)
        cost_new = float(np.sum(residual(x_new) ** 2))
        if cost_new < cost:
            rel = (cost - cost_new) / max(cost, 1e-300)
            x, cost = x_new, cost_new
            lam = max(lam / 10.0, 1e-12)
            if rel < 1e-12:
                converged = True
                break
        else:
            lam *= 10.0
            if lam > 1e12:
                # no step improves the cost anymore: a (local) optimum
                converged = True
                break

    # covariance from the Gauss-Newton approximation at the optimum
    J = _jacobian(residual, x)
    dof = max(len(y) - len(free_names), 1)
    redchi = cost / dof
    try:
        cov_scaled = np.linalg.inv(J.T @ J) * redchi
    except np.linalg.LinAlgError:
        cov_scaled = np.full((len(x), len(x)), np.nan)
    cov = cov_scaled * np.outer(sc, sc)

    params = dict(p0)
    stderr = {}
    for i, nm in enumerate(free_names):
        params[nm] = float(x[i] * sc[i])
        stderr[nm] = float(np.sqrt(max(cov[i, i], 0.0)))
    return SchechterFit(params=params, stderr=stderr, cov=cov,
                        free_names=free_names, chisqr=cost, redchi=redchi,
                        success=converged,  # False = max_iter exhausted
                        log=log, integ=integ, alpha_fixed=alpha_value)
