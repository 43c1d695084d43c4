"""Frequentist coverage of the redshift-evolving (3-pivot) model (port
of ``examples/coverage_check_z.py``).

Catalogs are drawn from a NON-evolving Schechter process, so the true
value of every L* pivot is the generating Lstar and of every phi* pivot
the (amplitude-rescaled) phistar: the quadratic evolution model must
recover flat evolution with nominal interval coverage. ``--natural``
fits the value/slope/curvature parameterization instead, whose truths
are (Lstar, 0, 0, phistar, 0, 0, sch_al).

    python -m lumfuncmcmc_tpu_torch.examples.coverage_check_z [K] [--natural] [--device cpu]
"""

import sys
import time

import numpy as np

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.examples import parse_args
from lumfuncmcmc_tpu_torch.models.model import LumFuncModelZ
from lumfuncmcmc_tpu_torch.utils.calibration import (
    _interval_coverage, _log_split, _model, _sample, _uniform_start)
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)


def one_replicate(k, rng, natural=False, n_target=1500, nwalkers=64,
                  nsteps=1500, pad=2048, device=None):
    """One replicate: ``({name: (in68, in95)}, names)``."""
    t0 = time.perf_counter()
    truth = dict(Lstar=rng.uniform(42.2, 42.8),
                 phistar=rng.uniform(-3.2, -2.2),
                 sch_al=rng.uniform(-1.8, -1.2))
    cfg = LFConfig(min_comp_frac=0.5, fix_comp=True, quadrature="gauss",
                   nwalkers=nwalkers, nsteps=nsteps, seed=k,
                   z_param="natural" if natural else "pivots", **truth)
    cat = apply_completeness_cut(
        make_catalog(cfg, n_target=n_target, seed=2000 + k,
                     lum_err_dex=0.0), cfg)
    phistar_eff = cat["theta_true"]["phistar"]
    model = _model(LumFuncModelZ, cfg, cat, device, pad)
    pos0 = _uniform_start(model, 2 * k)
    setup_s = time.perf_counter() - t0
    chain, burn, _, run_s = _sample(model, pos0, 2 * k + 1)
    layout = model.layout
    post = chain[burn:].reshape(-1, layout.ndim)
    if natural:
        truths = [truth["Lstar"], 0.0, 0.0, phistar_eff, 0.0, 0.0,
                  truth["sch_al"]]
    else:
        truths = ([truth["Lstar"]] * 3 + [phistar_eff] * 3
                  + [truth["sch_al"]])
    _log_split("z", k, len(cat["z"]), setup_s, run_s,
               model.lnprob_batch().engine)
    return (_interval_coverage(post, list(layout.names),
                               dict(zip(layout.names, truths))),
            list(layout.names))


def run(K=30, natural=False, device=None, **sizes):
    """K replicates from ``default_rng(11)`` (``sizes``: the keywords of
    :func:`one_replicate`); prints the running and final coverage.
    Returns ``(hits68, hits95)`` per parameter."""
    rng = np.random.default_rng(11)
    hits68 = hits95 = None
    t0 = time.time()
    for k in range(K):
        cover, names = one_replicate(k, rng, natural=natural,
                                     device=device, **sizes)
        if hits68 is None:
            hits68 = {p: 0 for p in names}
            hits95 = {p: 0 for p in names}
        for p in names:
            hits68[p] += cover[p][0]
            hits95[p] += cover[p][1]
        print(f"replicate {k + 1}/{K}: "
              f"{ {p: hits68[p] for p in names} }", flush=True)
    dt = time.time() - t0
    print(f"\n=== z-model coverage over {K} replicates "
          f"({dt:.0f}s, {dt / K:.2f} s per replicate) ===")
    for p in names:
        print(f"  {p:8s}: 68% covers {hits68[p] / K:.2f} "
              f"(nominal 0.68); 95% covers {hits95[p] / K:.2f}")
    return hits68, hits95


def main(argv=None):
    args = parse_args(argv, __doc__, replicates=30, flags=(
        ("--natural", "the value/slope/curvature parameterization"),))
    run(args.K, natural=args.natural, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
