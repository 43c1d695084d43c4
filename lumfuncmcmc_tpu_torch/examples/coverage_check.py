"""Frequentist coverage check of the full inference pipeline (port of
``examples/coverage_check.py``).

Draws K synthetic catalogs from known truths (varied per replicate),
runs the complete fit on each
(:func:`~lumfuncmcmc_tpu_torch.utils.calibration.coverage_replicate`)
and reports how often the central 68% / 95% posterior intervals cover
the true parameters. A correct likelihood + sampler + quadrature stack
gives nominal coverage (binomial error ~ sqrt(p(1-p)/K)); a bias in any
layer shows as under- or over-coverage.

    python -m lumfuncmcmc_tpu_torch.examples.coverage_check [K] [--free] [--pallas] [--mix] [--init-map] [--device cpu]
"""

import sys
import time

import numpy as np

from lumfuncmcmc_tpu_torch.examples import parse_args
from lumfuncmcmc_tpu_torch.utils.calibration import (
    PARAMS, coverage_replicate)

FLAGS = (("--free", "the 9-parameter free-completeness model"),
         ("--pallas", "the value kernel's route (its plain version on "
                      "the CPU); default: the model's engine"),
         ("--mix", "the stretch + differential-evolution mix"),
         ("--init-map", "Laplace warm starts around the MAP"))


def run(K=40, free=False, pallas=None, move="stretch", init_map=False,
        n_target=1500, nwalkers=64, nsteps=None, pad=2048, device=None):
    """K replicates from ``default_rng(7)``; prints the running and final
    coverage. Returns ``(hits68, hits95)`` per parameter."""
    rng = np.random.default_rng(7)
    params = list(PARAMS) + ([f"Flim_{i}" for i in range(5)] + ["alpha"]
                             if free else [])
    hits68 = {p: 0 for p in params}
    hits95 = {p: 0 for p in params}
    t0 = time.time()
    for k in range(K):
        cover = coverage_replicate(
            k, rng, free=free, pallas=pallas, move=move, init_map=init_map,
            n_target=n_target, nwalkers=nwalkers, nsteps=nsteps, pad=pad,
            device=device)
        for p in params:
            hits68[p] += cover[p][0]
            hits95[p] += cover[p][1]
        done = {p: f"{hits68[p]}/{k + 1}" for p in params}
        print(f"replicate {k + 1}/{K}: 68% running coverage {done}",
              flush=True)
    dt = time.time() - t0
    print(f"\n=== coverage over {K} replicates ({dt:.0f}s, "
          f"{dt / K:.2f} s per replicate) ===")
    err = np.sqrt(0.68 * 0.32 / K)
    for p in params:
        print(f"  {p:8s}: 68% interval covers {hits68[p] / K:.2f} "
              f"(nominal 0.68 +- {err:.2f}); "
              f"95% covers {hits95[p] / K:.2f} (nominal 0.95)")
    return hits68, hits95


def main(argv=None):
    args = parse_args(argv, __doc__, replicates=40, flags=FLAGS)
    run(args.K, free=args.free, pallas=True if args.pallas else None,
        move="mix" if args.mix else "stretch", init_map=args.init_map,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
