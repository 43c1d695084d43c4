"""Ensemble-sampler fit driver (port of ``fit_model`` from
``lumfuncmcmc_tpu/models/ensemble_driver.py``, without checkpointing).

The host class provides ``cfg``/``log``/``layout``/``device``/``dtype``,
``lnprob_batch``, ``_initial_positions`` and ``_log_convergence``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.samplers.affine import run_stretch
from lumfuncmcmc_tpu_torch.samplers.diagnostics import (
    burnin_steps, effective_sample_size, gelman_rubin)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _EnsembleDriverMixin:
    """Stretch-ensemble fit driver."""

    def fit_model(self, generator=None):
        """Run the ensemble sampler; the reference's ``fit_model``
        logging and burn-in rule. ``generator`` (default: seeded with
        ``cfg.seed`` on the run's device) supplies the walker starts
        and every sampler draw."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(cfg.seed)
        lnprob = self.lnprob_batch()
        pos0 = self._initial_positions(generator)
        ndim = pos0.shape[1]

        self.log.info(
            "Fitting Schechter model to true luminosity function using the "
            "PyTorch affine-invariant ensemble sampler (engine: %s, "
            "device: %s)" % (getattr(lnprob, "engine", "eager"),
                             self.device))
        thin = max(cfg.thin, 1)
        if thin > cfg.nsteps:
            raise ValueError(
                f"thin={thin} exceeds nsteps={cfg.nsteps}: no step would "
                "ever be recorded")
        nsteps_exec = cfg.nsteps - (cfg.nsteps % thin)
        if nsteps_exec != cfg.nsteps:
            self.log.warning(
                "nsteps=%d is not a multiple of thin=%d; running %d steps"
                % (cfg.nsteps, thin, nsteps_exec))
        _sync(self.device)
        start = time.perf_counter()
        state, chain, lnps, acc = run_stretch(
            lnprob, pos0, generator, nsteps_exec, thin=thin, move=cfg.move,
            de_prob=cfg.de_prob)
        _sync(self.device)
        elapsed = time.perf_counter() - start
        chain = chain.double().cpu().numpy()
        lnps = lnps.double().cpu().numpy()
        acc = acc.double().cpu().numpy()
        self.log.info("Total time taken: %0.4f s" % elapsed)
        self.log.info("Time taken per step per walker: %0.4f ms" %
                      (elapsed / nsteps_exec * 1000.0 / cfg.nwalkers))
        self.log.info("lnprob evaluations/s: %0.1f"
                      % (cfg.nwalkers * nsteps_exec / elapsed))

        # with thinning, tau is measured in recorded-step units
        burn, tau = burnin_steps(chain, chain.shape[0])
        self.acceptance_fraction = float(np.mean(acc) / nsteps_exec)
        self.log.info("Mean acceptance fraction: %0.4f" %
                      self.acceptance_fraction)
        self.log.info("AutoCorrelation Steps: %i, Number of Burn-in "
                      "Steps: %i" % (round(tau), burn))
        ess = effective_sample_size(chain[burn:])
        rhat = gelman_rubin(chain[burn:])
        self._log_convergence(chain[burn:])
        self.log.info("min ESS: %.0f; max R-hat: %.4f; ESS/sec: %.0f"
                      % (ess.min(), rhat.max(), ess.min() / elapsed))

        # (nsteps, W, D) -> flat post-burn samples with LnProb as the
        # last column, like the reference
        self.chain = chain
        full = np.concatenate([chain, lnps[:, :, None]], axis=2)
        self.samples = full[burn:].reshape(-1, ndim + 1)
        self.log.info("Shape of self.samples")
        self.log.info(str(self.samples.shape))
        self.log.info("Median lnprob: %.5f; Max lnprob: %.5f"
                      % (np.median(lnps), np.max(lnps)))
        return self.samples
