"""NUTS fit driver (port of ``fit_model_nuts``, ``_nuts_gradient_post``,
the min-ess block loop and the checkpoint protocol of
``lumfuncmcmc_tpu/models/nuts_driver.py``), meshless and single-process
(a grid of ranks refuses NUTS: its mesh routes are not ported yet).

A run is a first block (``run_nuts``: warmup and the first samples) and
continuation blocks (``continue_nuts`` from the frozen ``(y_run, eps,
scale)``), all drawing from one generator in transition order. So a
fixed-length run checkpointed in blocks of ``checkpoint_every`` samples
is the plain ``run_nuts(num_samples=nsteps)`` chain exactly, and a
min-ess run of B blocks is the plain run of B x ``nsteps`` samples. The
npz holds the samples so far, the frozen state and the generator's state
(``Generator.get_state()``) at the block boundary: a resume skips the
start guard and warmup and reproduces the uninterrupted chain, and the
min-ess run's stopping decisions, exactly on one device type. Its
fingerprint (``ensemble_driver.fingerprint``) pins the JAX fingerprint's
knobs, the port's protocol tag and the device type. Every block's
frozen state and generator state are kept (``y_run``, ``generator``,
first axis the block), so cutting the npz's arrays at a block gives the
checkpoint that block boundary wrote.

The host class provides ``cfg``/``log``/``layout``/``ctx``/``device``/
``dtype``/``model_kind``, ``lnprob_batch``, ``_make_scalar_lnprob``,
``_initial_positions``, ``_resolve_use_pallas``, ``_check_precision`` and
``_log_convergence``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.models.ensemble_driver import (
    _sync, fingerprint, load_checkpoint, npz_path)
from lumfuncmcmc_tpu_torch.ops.cuda_lnlike import MAX_ROWS
from lumfuncmcmc_tpu_torch.samplers.diagnostics import (
    effective_sample_size, gelman_rubin)
from lumfuncmcmc_tpu_torch.samplers.nuts import (
    NutsCounts, continue_nuts, make_unconstrained, resample_bad_starts,
    run_nuts)


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
        if self.exact_bounds:
            # no kernel computes the exact bounds (nor the explicit
            # use_pallas error, which is the ensemble engine's contract)
            self.log.info("NUTS gradient path: autograd of the eager "
                          "exact-bounds engine")
            return self._check_precision(self._make_scalar_lnprob())
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

    def _nuts_fp(self, nchains, ndim, num_warmup, every=None):
        """The NUTS checkpoint fingerprint ``(values, names)``: the JAX
        package's fields (``every`` on the fixed-length protocol)."""
        cfg = self.cfg
        fields = [("nchains", nchains), ("num_warmup", int(num_warmup)),
                  ("block_steps" if every is None else "nsteps",
                   int(cfg.nsteps))]
        if every is not None:
            fields.append(("checkpoint_every", int(every)))
        fields += [("ndim", ndim), ("seed", cfg.seed),
                   ("target_accept", float(cfg.nuts_target_accept))]
        return fingerprint(self.device, fields)

    def _nuts_ckpt_save(self, path, fp, blocks, state, ends):
        """The accumulated blocks, the frozen step size and mass, and at
        each block boundary the chains' state and the generator's
        (``ends``: (y_run, generator state) per block)."""
        def host(x):
            return x.double().cpu().numpy()
        np.savez(path, **{k: host(torch.cat([b[i] for b in blocks]))
                          for i, k in enumerate(("samples_y", "lnps_y",
                                                 "alphas"))},
                 df=np.asarray([b[3] for b in blocks], dtype=np.float64),
                 sizes=np.asarray([b[0].shape[0] for b in blocks]),
                 y_run=np.stack([host(e[0]) for e in ends]),
                 generator=np.stack([e[1].numpy() for e in ends]),
                 eps=host(state[1]), scale=host(state[2]), fingerprint=fp)

    def _nuts_ckpt_load(self, path, fp, names, label, generator):
        """``(blocks, state, ends)`` of a checkpoint, the generator put
        back to its last block boundary; raises on a fingerprint
        mismatch."""
        ck = load_checkpoint(path, fp, names, label)

        def dev(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)
        edges = np.concatenate([[0], np.cumsum(ck["sizes"])])
        blocks = [tuple(dev(ck[k][a:b]) for k in ("samples_y", "lnps_y",
                                                  "alphas")) + (float(d),)
                  for a, b, d in zip(edges[:-1], edges[1:], ck["df"])]
        ends = [(dev(y), torch.as_tensor(g, dtype=torch.uint8))
                for y, g in zip(ck["y_run"], ck["generator"])]
        generator.set_state(ends[-1][1])
        return blocks, (ends[-1][0], dev(ck["eps"]), dev(ck["scale"])), ends

    def _nuts_block_ess(self, blocks, to_theta):
        """Min ESS over the parameters of the theta chain so far."""
        ys = torch.cat([b[0] for b in blocks])
        return float(effective_sample_size(
            to_theta(ys).double().cpu().numpy()).min())

    def fit_model_nuts(self, generator=None, num_warmup=None, nchains=8,
                       min_ess=None, max_blocks=50, checkpoint_path=None,
                       resume=False):
        """Gradient-based NUTS fit of the same posterior; the same
        ``self.samples`` layout as :meth:`fit_model` (no burn-in: warmup
        is discarded inside the sampler) with the theta-space Ln Prob
        column. ``generator`` (default: seeded with ``cfg.seed`` on the
        run's device) supplies the starts and every sampler draw. The
        work of the run is left in ``self.nuts_counts``.

        ``min_ess``: after the first ``cfg.nsteps`` samples, extend the
        chain in ``cfg.nsteps``-sample blocks (:func:`continue_nuts`,
        frozen step size and mass) until every parameter reaches
        ``min_ess`` effective samples or ``max_blocks`` blocks ran.
        ``checkpoint_path``/``resume``: with ``min_ess`` the checkpoint
        unit is the block; without it, ``0 < cfg.checkpoint_every <
        cfg.nsteps`` cuts the run into blocks of that many samples, the
        chain equal to the unblocked run's (the module's protocol).
        """
        cfg = self.cfg
        grid = getattr(self, "grid", None)
        if grid is not None:
            raise NotImplementedError(
                f"--sampler nuts on a grid of {grid.size} ranks is not "
                "ported yet (run it with the JAX package, lumfuncmcmc_tpu)")
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
        nchains = min(nchains, cfg.nwalkers)
        ndim = self.layout.ndim
        nsteps = int(cfg.nsteps)
        every = int(cfg.checkpoint_every or 0)
        if min_ess:
            sizes, ck = None, npz_path(checkpoint_path)
            fp, names = self._nuts_fp(nchains, ndim, num_warmup)
            label = "nuts-min-ess"
        elif checkpoint_path and 0 < every < nsteps:
            nb = -(-nsteps // every)
            sizes = [every] * (nb - 1) + [nsteps - every * (nb - 1)]
            ck = npz_path(checkpoint_path)
            fp, names = self._nuts_fp(nchains, ndim, num_warmup, every)
            label = "nuts-checkpoint"
        else:
            sizes, ck = [nsteps], None
        blocks, state, ends = [], None, []
        resumed = bool(resume and ck and os.path.exists(ck))
        if resumed:
            blocks, state, ends = self._nuts_ckpt_load(ck, fp, names, label,
                                                       generator)
        post = self._nuts_gradient_post()
        lo, hi = self.layout.bounds_arrays(self.dtype, self.device)
        lnp_y, to_theta, to_y = make_unconstrained(post, lo, hi)
        if resumed:
            self.log.info("NUTS start guard skipped: resuming from %s "
                          "(%d blocks, %d samples; warmup skipped)"
                          % (ck, len(blocks),
                             sum(b[0].shape[0] for b in blocks)))
        else:
            y0 = self._nuts_starts(generator, nchains, lo, hi, to_y)

        self.log.info("Fitting with NUTS (%d chains, %d warmup, %d "
                      "samples%s)" % (nchains, num_warmup, nsteps,
                                      " a block" if min_ess else ""))
        counts = NutsCounts()
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            if min_ess and blocks:
                ess_now = self._nuts_block_ess(blocks, to_theta)
                self.log.info("NUTS block %d: %d samples, min ESS=%.0f "
                              "(target %.0f)" % (
                                  len(blocks),
                                  sum(b[0].shape[0] for b in blocks),
                                  ess_now, float(min_ess)))
                if ess_now >= float(min_ess) or len(blocks) >= max_blocks:
                    break
            elif not min_ess and len(blocks) == len(sizes):
                break
            n = nsteps if min_ess else sizes[len(blocks)]
            if state is None:
                run = run_nuts(lnp_y, y0, generator,
                               num_warmup=int(num_warmup), num_samples=n,
                               target_accept=float(cfg.nuts_target_accept))
                counts = run.counts
            else:
                run = continue_nuts(lnp_y, state, generator, n,
                                    counts=counts)
            state = run.state
            blocks.append((run.samples, run.lnps, run.alphas,
                           float(run.div_frac)))
            if ck:
                ends.append((state[0], generator.get_state()))
                self._nuts_ckpt_save(ck, fp, blocks, state, ends)
        _sync(self.device)
        elapsed = time.perf_counter() - t0

        samples = torch.cat([b[0] for b in blocks])
        sizes_run = [b[0].shape[0] for b in blocks]
        div_frac = float(np.dot([b[3] for b in blocks], sizes_run)
                         / sum(sizes_run))
        chain_dev = to_theta(samples)
        # record the THETA-space lnprob (the y-space density carries the
        # logit Jacobian, which would contaminate lnprobcut selection and
        # the fitposterior "Ln Prob" column)
        lnps = self._theta_lnprob(chain_dev).double().cpu().numpy()
        chain = chain_dev.double().cpu().numpy()
        alphas = torch.cat([b[2] for b in blocks]).double().cpu().numpy()
        counts.lane_leapfrogs = float(counts.lane_leapfrogs)
        self.nuts_counts = counts
        self.log.info("Total time taken: %0.2f s; step size %.4g; mean "
                      "accept-stat %.2f; divergent transitions %.2f%%"
                      % (elapsed, float(state[1]), float(np.mean(alphas)),
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

    def _nuts_starts(self, generator, nchains, lo, hi, to_y):
        """Chain starts in y: the first ``nchains`` walker starts (shrunk
        toward the box centre unless the Laplace starts ran), the
        stuck-start guard applied."""
        start = self._initial_positions(generator)[:nchains]
        if not getattr(self, "_init_from_map", False):
            # NUTS needs a finite gradient start, and the extreme corners
            # have ~-1e6 lnlike. Gated on the init that ran, not on
            # cfg.init_map: the Laplace init falls back to uniform draws
            # when the mode Hessian is unusable, and real Laplace starts
            # sit at the mode
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
        return y0
