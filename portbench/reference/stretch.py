"""Plain reference of the affine-invariant stretch move (Goodman & Weare
2010; emcee's red-black ``StretchMove``), as a judge of a recorded chain.

A step moves the walkers' first half against the second, then the second
half against the updated first. Walker ``k`` of the moving half proposes
``Y = X_j + z (X_k - X_j)``, with ``X_j`` a walker of the other half and
``z`` in ``[1/a, a]``, and takes ``Y`` where ``ln u < (D - 1) ln z + lnp(Y)
- lnp(X_k)``, ``u`` uniform on [0, 1); otherwise it keeps ``X_k``. The
randoms are the program's, so a single decision is judged only where the
rule fixes it: the log ratio ``r`` above 0 must take ``Y``; ``r`` below
-40 must keep ``X_k`` (a chance under 1e-17 of taking it, unless ``u``
drew exactly 0, about 3e-8 a float32 draw), and an lnp of -inf always
keeps it.

Each half-step is judged from what the program recorded: the walkers
before and after it with their lnp, the proposals it evaluated with
their lnp, and the other half. ``z`` and the partner are worked out again
from the positions. Counts over one fit:

- ``bad_moves``: walkers whose new state (position and lnp) is neither
  the proposal nor the old state, bit for bit;
- ``bad_proposals``: proposals that are no stretch move of their walker,
  with a partner from the other half and ``z`` in ``[1/a, a]``, to
  float rounding;
- ``bad_takes``: walkers that kept their state where the rule takes
  the proposal, beyond the rounding of the program's own log ratio;
- ``bad_keeps``: walkers that took the proposal where the rule keeps
  the state (a sound run can read one where ``u`` drew 0);
- ``forced_takes``, ``forced_keeps``: the decisions that the rule fixes
  (reported, not compared).
"""

from __future__ import annotations

import math

import torch

# |r| below this, plus the rounding of the program's lnp, is not judged
R_TOL = 0.01
# the log ratio below which the rule keeps the old state
R_REJECT = -40.0


def _partners(prop, walker, other, scale):
    """For proposals ``prop`` (S, n, D) of walkers ``walker`` (S, n, D)
    against the other half ``other`` (S, m, D): ``(z, resid, ubound)``,
    each (S, n), of the best-fitting partner: the stretch factor, the
    largest misfit of ``prop - X_j - z (X_k - X_j)`` over the dimensions in
    units of ``scale`` (D,), and a bound on the error of ``z``."""
    u = walker[:, :, None, :] - other[:, None, :, :]          # (S, n, m, D)
    v = prop[:, :, None, :] - other[:, None, :, :]
    uu = (u * u).sum(-1)
    z = (v * u).sum(-1) / torch.where(uu > 0, uu, torch.ones_like(uu))
    miss = ((v - z[..., None] * u).abs() / scale).amax(-1)
    miss = torch.where(uu > 0, miss, torch.full_like(miss, math.inf))
    best = miss.argmin(-1, keepdim=True)
    z = z.gather(-1, best)[..., 0]
    resid = miss.gather(-1, best)[..., 0]
    norm = uu.gather(-1, best)[..., 0].sqrt()
    # a float32 proposal is off by at most ~0.12 scale a dimension
    ubound = scale.norm() / torch.clamp(norm, min=1e-300)
    return z, resid, ubound


def judge_fit(x0, l0, chain, lnps, props, lprops, a=2.0, chunk=64,
              device="cpu"):
    """Counts of one fit of ``S`` steps and ``W`` walkers of dimension D:
    start ``x0`` (W, D) with lnp ``l0`` (W,); ``chain`` (S, W, D) and
    ``lnps`` (S, W) after each step; ``props`` (S, 2, W/2, D) and
    ``lprops`` (S, 2, W/2) evaluated by each half-step. Arrays of the
    program's own values; judged in float64."""
    f64 = dict(dtype=torch.float64, device=device)
    x0, l0 = torch.as_tensor(x0, **f64), torch.as_tensor(l0, **f64)
    chain, lnps = torch.as_tensor(chain, **f64), torch.as_tensor(lnps, **f64)
    props = torch.as_tensor(props, **f64)
    lprops = torch.as_tensor(lprops, **f64)
    steps, nw, ndim = chain.shape
    nh = nw // 2
    # rounding unit of each dimension: 1e-6 of its largest magnitude
    scale = 1e-6 * torch.maximum(chain.abs().amax((0, 1)),
                                 props.abs().amax((0, 1, 2)))
    scale = torch.clamp(scale, min=1e-300)
    out = {"bad_moves": 0, "bad_proposals": 0, "bad_takes": 0,
           "bad_keeps": 0, "forced_takes": 0, "forced_keeps": 0}
    for s0 in range(0, steps, chunk):
        s1 = min(steps, s0 + chunk)
        before = torch.cat([x0[None], chain[:s1 - 1]])[s0:s1]
        lbefore = torch.cat([l0[None], lnps[:s1 - 1]])[s0:s1]
        after, lafter = chain[s0:s1], lnps[s0:s1]
        for half in (0, 1):
            mv = slice(0, nh) if half == 0 else slice(nh, nw)
            # the first half moves against the second as it was; the
            # second against the first as it now is
            other = before[:, nh:] if half == 0 else after[:, :nh]
            old, lold = before[:, mv], lbefore[:, mv]
            new, lnew = after[:, mv], lafter[:, mv]
            p, lp = props[s0:s1, half], lprops[s0:s1, half]
            took = (new == p).all(-1) & ((lnew == lp) | (lnew.isnan()
                                                         & lp.isnan()))
            kept = (new == old).all(-1) & ((lnew == lold) | (lnew.isnan()
                                                             & lold.isnan()))
            out["bad_moves"] += int((~took & ~kept).sum())
            z, resid, dz = _partners(p, old, other, scale)
            legal = ((resid < 100.0) & (z >= (1.0 / a) * (1.0 - 1e-6) - dz)
                     & (z <= a * (1.0 + 1e-6) + dz))
            out["bad_proposals"] += int((~legal).sum())
            lnz = torch.log(torch.clamp(z, min=1e-300))
            r = (ndim - 1.0) * lnz + lp - lold
            slack = (R_TOL + 1e-6 * (lp.abs() + lold.abs())
                     + (ndim - 1.0) * dz / torch.clamp(z, min=1e-300))
            finite = torch.isfinite(lold)
            must_take = legal & finite & (r > slack)
            must_keep = legal & finite & ((lp == -math.inf)
                                          | (r < R_REJECT - slack))
            decided = took ^ kept
            out["bad_takes"] += int((must_take & decided & kept).sum())
            out["bad_keeps"] += int((must_keep & decided & took).sum())
            out["forced_takes"] += int(must_take.sum())
            out["forced_keeps"] += int(must_keep.sum())
    return out
