"""NUTS fit driver (port of ``fit_model_nuts`` and
``_nuts_gradient_post`` from ``lumfuncmcmc_tpu/models/nuts_driver.py``),
meshless, without checkpoints and without ``min_ess``.

The host class provides ``cfg``/``log``/``layout``/``ctx``/``device``/
``dtype``/``model_kind``, ``lnprob_batch``, ``_make_scalar_lnprob``,
``_initial_positions``, ``_resolve_use_pallas``, ``_check_precision`` and
``_log_convergence``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.models.ensemble_driver import _sync
from lumfuncmcmc_tpu_torch.ops.cuda_lnlike import MAX_ROWS
from lumfuncmcmc_tpu_torch.samplers.diagnostics import (
    effective_sample_size, gelman_rubin)
from lumfuncmcmc_tpu_torch.samplers.nuts import (
    make_unconstrained, resample_bad_starts, run_nuts)


class _NutsDriverMixin:
    """NUTS fit driver: gradient-engine choice and the run."""

    def _nuts_gradient_post(self):
        """The batched lnprob NUTS differentiates, (C, D) -> (C,).

        The port's own rule (no TPU tuning carries over): on a CUDA
        device the value+gradient kernel of the model's family, both
        completeness modes, the z model and the hierarchical one alike,
        the streaming one for a mega catalog under free completeness
        (:func:`make_cuda_lnprob_and_grad`); on the CPU autograd of the
        eager engine, or of the kernels' plain value+gradient versions
        under ``--use-pallas``.
        """
        if self.cfg.exact_bounds:
            raise NotImplementedError(
                "exact_bounds is not ported yet (it needs the in-graph "
                "completeness-root bisection)")
        if self.device.type == "cuda" or self._resolve_use_pallas():
            from lumfuncmcmc_tpu_torch.ops.cuda_lnlike import (
                make_cuda_lnprob_and_grad)
            post = make_cuda_lnprob_and_grad(self.ctx, self.layout,
                                             model=self.model_kind)
            cuda = post.engine.startswith("cuda")
            self.log.info("NUTS gradient path: %s value+gradient %s"
                          % ("CUDA" if cuda else "plain",
                             "kernel" if cuda else "versions of the kernels"))
            return self._check_precision(post)
        self.log.info("NUTS gradient path: autograd of the eager engine")
        return self._check_precision(self._make_scalar_lnprob())

    def _theta_lnprob(self, chain):
        """Theta-space lnprob of (S, C, D) thetas through the model's
        ``lnprob_batch``, at most ``MAX_ROWS`` rows (one kernel
        launch) per call."""
        lnprob = self.lnprob_batch()
        flat = chain.reshape(-1, chain.shape[-1])
        with torch.no_grad():
            out = torch.cat([lnprob(flat[i:i + MAX_ROWS])
                             for i in range(0, flat.shape[0], MAX_ROWS)])
        return out.reshape(chain.shape[:2])

    def fit_model_nuts(self, generator=None, num_warmup=None, nchains=8):
        """Gradient-based NUTS fit of the same posterior; the same
        ``self.samples`` layout as :meth:`fit_model` (no burn-in: warmup
        is discarded inside the sampler) with the theta-space Ln Prob
        column. ``generator`` (default: seeded with ``cfg.seed`` on the
        run's device) supplies the starts and every sampler draw. The
        work of the run is left in ``self.nuts_counts``."""
        cfg = self.cfg
        if not 0.0 < float(cfg.nuts_target_accept) < 1.0:
            raise ValueError(
                "nuts_target_accept must be strictly between 0 and 1 "
                "(acceptance-statistic target, Stan default 0.8), got "
                f"{cfg.nuts_target_accept}")
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(cfg.seed)
        num_warmup = num_warmup or max(200, cfg.nsteps // 4)
        if cfg.move != "stretch":
            self.log.warning(
                "--move %s is an ensemble-proposal option; it is "
                "ignored under --sampler nuts" % cfg.move)
        post = self._nuts_gradient_post()
        pos = self._initial_positions(generator)
        nchains = min(nchains, pos.shape[0])
        lo, hi = self.layout.bounds_arrays(self.dtype, self.device)
        lnp_y, to_theta, to_y = make_unconstrained(post, lo, hi)
        start = pos[:nchains]
        if not getattr(self, "_init_from_map", False):
            # shrink uniform starts toward the box centre: NUTS needs a
            # finite gradient start, and the extreme corners have ~-1e6
            # lnlike. Gated on the init that ran, not on cfg.init_map:
            # the Laplace init falls back to uniform draws when the mode
            # Hessian is unusable, and real Laplace starts sit at the mode
            start = 0.8 * ((lo + hi) / 2.0)[None, :] + 0.2 * start
        y0 = to_y(start)
        # the stuck-start guard needs values only: the forward lnprob
        guard_y, _, _ = make_unconstrained(self.lnprob_batch(), lo, hi)
        y0, good = resample_bad_starts(guard_y, y0, generator)
        n_bad = int((~good).sum())
        if n_bad:
            self.log.info(
                "Resampled %d/%d NUTS starts (robust low outliers of the "
                "start-lnp distribution — stuck-chain guard)"
                % (n_bad, y0.shape[0]))

        self.log.info("Fitting with NUTS (%d chains, %d warmup, %d "
                      "samples)" % (nchains, num_warmup, cfg.nsteps))
        _sync(self.device)
        t0 = time.perf_counter()
        run = run_nuts(lnp_y, y0, generator, num_warmup=int(num_warmup),
                       num_samples=int(cfg.nsteps),
                       target_accept=float(cfg.nuts_target_accept))
        _sync(self.device)
        elapsed = time.perf_counter() - t0

        chain_dev = to_theta(run.samples)
        # record the THETA-space lnprob (the y-space density carries the
        # logit Jacobian, which would contaminate lnprobcut selection and
        # the fitposterior "Ln Prob" column)
        lnps = self._theta_lnprob(chain_dev).double().cpu().numpy()
        chain = chain_dev.double().cpu().numpy()
        alphas = run.alphas.double().cpu().numpy()
        div_frac = float(run.div_frac)
        counts = run.counts
        counts.lane_leapfrogs = float(counts.lane_leapfrogs)
        self.nuts_counts = counts
        self.log.info("Total time taken: %0.2f s; step size %.4g; mean "
                      "accept-stat %.2f; divergent transitions %.2f%%"
                      % (elapsed, float(run.eps), float(np.mean(alphas)),
                         100.0 * div_frac))
        self.log.info(
            "NUTS work: %d transitions, %d leapfrog steps (batched over "
            "%d chains), %d host syncs; leapfrogs per transition: batched "
            "mean %.2f, max %d, per chain mean %.2f"
            % (counts.transitions, counts.leapfrogs, nchains, counts.syncs,
               counts.leapfrogs / max(counts.transitions, 1),
               counts.max_leapfrogs,
               counts.lane_leapfrogs / max(counts.transitions * nchains,
                                           1)))
        if div_frac > 0.01:
            self.log.warning(
                "%.1f%% of NUTS transitions diverged — the posterior "
                "may be biased near high-curvature regions; consider "
                "raising --nuts-target-accept (smaller adapted steps) "
                "or more warmup" % (100.0 * div_frac))
        ess = effective_sample_size(chain)
        rhat = gelman_rubin(chain)
        self._log_convergence(chain)
        self.log.info("min ESS: %.0f; max R-hat: %.4f; ESS/sec: %.0f"
                      % (ess.min(), rhat.max(), ess.min() / elapsed))
        self.chain = chain
        full = np.concatenate([chain, lnps[:, :, None]], axis=2)
        self.samples = full.reshape(-1, chain.shape[2] + 1)
        self.log.info("Shape of self.samples")
        self.log.info(str(self.samples.shape))
        return self.samples
