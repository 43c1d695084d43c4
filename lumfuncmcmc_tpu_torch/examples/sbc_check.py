"""Simulation-based calibration (SBC; Talts et al. 2018) of the
fixed-completeness fit (port of ``examples/sbc_check.py``).

Draw theta* from the prior, generate a physical-normalization catalog
(2k-16k sources) from it, fit with the SAME prior, and rank theta*_d
among M posterior draws from distinct walkers >= 2 tau apart
(:func:`~lumfuncmcmc_tpu_torch.utils.calibration.sbc_replicate`). If
likelihood, quadrature, sampler and priors are all correct the rank is
uniform on {0..M}: a U shape means posteriors too narrow, a hump too
wide, a slope a location bias.

    python -m lumfuncmcmc_tpu_torch.examples.sbc_check [K] [--device cpu]
"""

import sys
import time

import numpy as np

from lumfuncmcmc_tpu_torch.examples import parse_args
from lumfuncmcmc_tpu_torch.utils.calibration import PARAMS, sbc_replicate

M = 7                     # posterior draws per rank -> M+1 rank bins


def run(K=48, nwalkers=64, nsteps=600, size_ln=None, device=None):
    """K replicates from ``default_rng(7)``; prints each replicate and
    the rank histograms with their chi^2. Returns the (K, 3) ranks."""
    rng = np.random.default_rng(7)
    t0 = time.time()
    all_ranks = np.empty((K, len(PARAMS)), dtype=int)
    for k in range(K):
        all_ranks[k], _, nsrc, tau = sbc_replicate(
            k, rng, nwalkers=nwalkers, nsteps=nsteps, M=M, size_ln=size_ln,
            device=device)
        print(f"  replicate {k + 1:3d}/{K}: N={nsrc}, tau={tau:.1f}, "
              f"ranks={all_ranks[k]}", flush=True)
    dt = time.time() - t0
    print(f"\n{K} replicates in {dt:.0f} s ({dt / K:.2f} s per replicate)")

    expected = K / (M + 1)
    print(f"rank histograms over {{0..{M}}} "
          f"(expected {expected:.1f} per bin):")
    for d, nm in enumerate(PARAMS):
        counts = np.bincount(all_ranks[:, d], minlength=M + 1)
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        # chi2 with M dof: mean M, sd sqrt(2M); flag > mean + 3 sd
        flag = "" if chi2 < M + 3 * np.sqrt(2 * M) else "  <-- CHECK"
        print(f"  {nm:8s} {counts}  chi2={chi2:.1f} (dof {M}){flag}")
    return all_ranks


def main(argv=None):
    args = parse_args(argv, __doc__, replicates=48)
    run(args.K, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
