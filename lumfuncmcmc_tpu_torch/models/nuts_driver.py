"""NUTS fit driver (port of ``fit_model_nuts``, ``_nuts_gradient_post``,
the mesh routes, the min-ess block loop and the checkpoint protocol of
``lumfuncmcmc_tpu/models/nuts_driver.py``), meshless or on the host's grid
of ranks (``self.grid``).

A run is a first block (warmup and the first samples: ``run_nuts``, or
on a grid ``parallel/sharding.py run_nuts_sharded``) and continuation
blocks (``continue_nuts`` / ``continue_nuts_sharded`` from the frozen
``(y_run, eps, scale)``), all drawing from one generator in transition
order. So a fixed-length run checkpointed in blocks of
``checkpoint_every`` samples is the plain ``run_nuts(num_samples=nsteps)``
chain exactly, and a
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

On a grid the run takes the route JAX's driver takes for the same command
line (:func:`nuts_route`): the chains go in blocks to the ranks of an axis,
every rank draws each transition's numbers for the whole batch from the
same generator and keeps its rows (``parallel/sharding.py``), and every
rank holds the gathered samples and the per-chain state ``(y_run (C, D),
eps (C,), scale (C, D))``. So the checkpoints are elastic: the fingerprint
does not pin the grid (the streaming route's source ranks excepted: their
sum's order is part of the arithmetic), and a checkpoint written on one
grid resumes on another, one rank included, as the run that did not stop.
Rank 0 alone writes; every rank decides a resume together (``agree``).

The host class provides ``cfg``/``log``/``layout``/``ctx``/``device``/
``dtype``/``model_kind``/``grid``, ``lnprob_batch``,
``_make_scalar_lnprob``, ``_initial_positions``, ``_resolve_use_pallas``,
``_require_active``, ``_check_precision`` and ``_log_convergence``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.models.ensemble_driver import (
    _digest, _save, _sync, fingerprint, load_checkpoint, npz_path)
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.parallel import sharding as sh
from lumfuncmcmc_tpu_torch.samplers.diagnostics import (
    effective_sample_size, gelman_rubin)
from lumfuncmcmc_tpu_torch.samplers.nuts import (
    NutsCounts, make_unconstrained, resample_bad_starts)

MAX_DOUBLINGS = 8       # a run's tree depth (the JAX driver's: run_nuts's
                        # default); a checkpoint fingerprints another


def nuts_route(cfg, model_kind, grid, nchains, ncells, nsources,
               use_pallas) -> str:
    """The NUTS route of a run: what JAX's ``fit_model_nuts`` computes for
    the same command line (``_nuts_stream_mesh_route`` and the branch at
    ``lumfuncmcmc_tpu/models/nuts_driver.py:84-105,590-700``); it decides
    which ranks hold which chains and whether they adapt together.

    - "meshless": no grid;
    - "stream": a source axis past one rank, a catalog that takes the
      streaming kernels (``cuda_lnlike.takes_stream``; JAX: past its
      resident-VMEM gate), the kernels on, no exact bounds: chains over
      the walker ranks, the catalog over the source ranks;
    - "replicas": the free single-epoch model on its value+gradient kernel
      (``use_pallas`` resolved on): chains over every rank, each adapting
      alone unless pooled (``--nuts-pooled``);
    - "pooled": every other case (fixed completeness, ``fitz``, ``fith``,
      exact bounds, the eager engine, and JAX's batch exception: the kernel
      left to auto with 96 chains or more a rank on at most 16,384 cells):
      chains over the walker ranks, the source ranks replicate, and the
      adaptation is pooled, as JAX's XLA-mesh path is.

    ``ncells``: the model's grid cells; ``nsources``: the catalog's."""
    if grid is None:
        return "meshless"
    free = (model_kind == "single" and not cfg.fix_comp
            and not cfg.exact_bounds)
    if not (free and use_pallas):
        return "pooled"
    if grid.n_sources > 1 and cl.takes_stream(model_kind, cfg.fix_comp,
                                              nsources):
        return "stream"
    if (cfg.use_pallas is None and max(1, nchains // grid.size) >= 96
            and ncells <= 16384):
        return "pooled"
    return "replicas"


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
            out = torch.cat([lnprob(flat[i:i + cl.MAX_ROWS])
                             for i in range(0, flat.shape[0], cl.MAX_ROWS)])
        return out.reshape(chain.shape[:2])

    def _nuts_route(self, nchains):
        """:func:`nuts_route` of this model and run (exact bounds take no
        kernel, and are not asked: ``--use-pallas`` with them is the
        ensemble engine's error, as in JAX)."""
        return nuts_route(self.cfg, self.model_kind, self.grid, nchains,
                          int(np.prod(self.ctx.logL_grid.shape)),
                          int(self.ctx.lum.shape[0]),
                          not self.exact_bounds
                          and self._resolve_use_pallas())

    def _nuts_grid_chains(self, route, nchains):
        """The chain count on the grid: a multiple of the ranks the route
        splits the chains over (rounded down, at least one a rank, with
        JAX's log line); too few walkers to seed them raises, as in JAX."""
        g = self.grid
        if route == "replicas":
            n, what = g.size, "mesh has %d devices" % g.size
            unit = "the %d-device mesh" % n
        else:
            n, what = g.n_walkers, ("mesh walker axis has %d devices"
                                    % g.n_walkers)
            unit = "the %d-device mesh walker axis" % n
        if n > self.cfg.nwalkers:
            raise ValueError(
                f"{what} but only {self.cfg.nwalkers} walkers are available "
                "to seed NUTS chains; raise nwalkers or shrink the mesh")
        if nchains % n:
            new = max(n, nchains - nchains % n)
            self.log.info("Rounding nchains %d -> %d (multiple of %s)"
                          % (nchains, new, unit))
            nchains = new
        return nchains

    def _nuts_fp(self, nchains, ndim, num_warmup, every=None, route=None):
        """The NUTS checkpoint fingerprint ``(values, names)``: the JAX
        package's fields (``every`` on the fixed-length protocol), and on
        the streaming route the source ranks (``mesh_sources``, as JAX's
        ``_nuts_fp`` appends: the order of the source group's sum is part
        of the arithmetic). No other grid field: the state is per chain
        and the draws per global chain, so any grid resumes it."""
        cfg = self.cfg
        fields = [("nchains", nchains), ("num_warmup", int(num_warmup)),
                  ("block_steps" if every is None else "nsteps",
                   int(cfg.nsteps))]
        if every is not None:
            fields.append(("checkpoint_every", int(every)))
        fields += [("ndim", ndim), ("seed", cfg.seed),
                   ("target_accept", float(cfg.nuts_target_accept))]
        if route == "stream":
            fields.append(("mesh_sources", self.grid.n_sources))
        if MAX_DOUBLINGS != 8:      # the depth of every earlier npz
            fields.append(("max_doublings", MAX_DOUBLINGS))
        return fingerprint(self.device, fields)

    def _nuts_ckpt_save(self, path, fp, blocks, state, ends):
        """The accumulated blocks, the frozen per-chain step size and
        mass, and at each block boundary the chains' state and the
        generator's (``ends``: (y_run, generator state) per block); rank 0
        alone writes (every rank holds the same gathered arrays)."""
        def host(x):
            return x.double().cpu().numpy()
        _save(path, **{k: host(torch.cat([b[i] for b in blocks]))
                       for i, k in enumerate(("samples_y", "lnps_y",
                                              "alphas"))},
              df=np.asarray([b[3] for b in blocks], dtype=np.float64),
              sizes=np.asarray([b[0].shape[0] for b in blocks]),
              y_run=np.stack([host(e[0]) for e in ends]),
              generator=np.stack([e[1].numpy() for e in ends]),
              eps=host(state[1]), scale=host(state[2]), fingerprint=fp)

    def _nuts_ckpt_load(self, path, fp, names, label, generator, resume):
        """``(blocks, state, ends)`` of the checkpoint at ``path`` to
        resume from, the generator put back to its last block boundary,
        or None for a fresh run (no ``resume``, or no file); raises
        on a fingerprint mismatch. On a grid every rank decides together:
        whether the file is there, whether it passed, its block count and
        a digest of its samples agree on every rank, or every rank
        raises. A meshless npz's step size and mass (one for all chains)
        are taken for every chain."""
        have = bool(resume and os.path.exists(path))
        ck, err = None, None
        if have:
            try:
                ck = load_checkpoint(path, fp, names, label)
            except ValueError as e:
                err = e
        if self.grid is not None:
            from lumfuncmcmc_tpu_torch.parallel.distributed import agree
            agree([have, err is None,
                   -1 if ck is None else len(ck["sizes"]),
                   _digest(ck, "samples_y")],
                  f"the {label} to resume from ({path})", self.grid.group)
        if err is not None:
            raise err
        if ck is None:
            return None

        def dev(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)
        edges = np.concatenate([[0], np.cumsum(ck["sizes"])])
        blocks = [tuple(dev(ck[k][a:b]) for k in ("samples_y", "lnps_y",
                                                  "alphas")) + (float(d),)
                  for a, b, d in zip(edges[:-1], edges[1:], ck["df"])]
        ends = [(dev(y), torch.as_tensor(g, dtype=torch.uint8))
                for y, g in zip(ck["y_run"], ck["generator"])]
        generator.set_state(ends[-1][1])
        y_run = ends[-1][0]
        eps = dev(ck["eps"]).expand(y_run.shape[0])
        scale = dev(ck["scale"]).expand(y_run.shape)
        return blocks, (y_run, eps, scale), ends

    def _nuts_block_ess(self, blocks, to_theta):
        """Min ESS over the parameters of the theta chain so far."""
        ys = torch.cat([b[0] for b in blocks])
        return float(effective_sample_size(
            to_theta(ys).double().cpu().numpy()).min())

    def _nuts_post(self, route):
        """The per-rank lnprob NUTS differentiates: the streaming route's
        source-summed one (sharing the value route's shard), else
        :meth:`_nuts_gradient_post`'s over the rank's whole catalog."""
        if route != "stream":
            return self._nuts_gradient_post()
        value = self.lnprob_batch()
        post = sh.make_cuda_lnprob_and_grad_stream_sharded(
            self.ctx, self.layout, self.grid, data=value.data)
        what = (("CUDA streaming", "kernel") if post.engine == "cuda-stream"
                else ("plain", "versions of the streaming kernels"))
        self.log.info("NUTS gradient path: %s value+gradient %s on source "
                      "shards, summed over %d source ranks"
                      % (*what, self.grid.n_sources))
        return self._check_precision(post)

    def _log_nuts_route(self, route, pooled, nchains):
        g = self.grid
        if route == "stream":
            self.log.info(
                "NUTS: source-sharded streaming value+gradient — catalog "
                "split over %d source ranks (one all_reduce a call), %d "
                "chains over %d walker ranks, %s step-size adaptation"
                % (g.n_sources, nchains, g.n_walkers,
                   "pooled" if pooled else "per-rank"))
        elif route == "replicas":
            self.log.info(
                "NUTS: per-rank replicas over the %d-rank grid, the "
                "value+gradient kernel per rank, %d chains, %s adaptation"
                % (g.size, nchains,
                   "pooled" if pooled else "independent per-rank"))
        elif route == "pooled":
            self.log.info(
                "NUTS chains sharded over the %d walker ranks (%d chains; "
                "the %d source ranks replicate), pooled adaptation"
                % (g.n_walkers, nchains, g.n_sources))

    def fit_model_nuts(self, generator=None, num_warmup=None, nchains=8,
                       pooled=None, min_ess=None, max_blocks=50,
                       checkpoint_path=None, resume=False):
        """Gradient-based NUTS fit of the same posterior; the same
        ``self.samples`` layout as :meth:`fit_model` (no burn-in: warmup
        is discarded inside the sampler) with the theta-space Ln Prob
        column. ``generator`` (default: seeded with ``cfg.seed`` on the
        run's device) supplies the starts and every sampler draw. The
        work of the run (this rank's, on a grid) is left in
        ``self.nuts_counts``.

        ``pooled``: on a grid, pooled step-size and mass adaptation over
        the ranks the chains split over (None: each route's default,
        per-rank for the replicas and pooled for the streaming route; the
        pooled route always pools), as in JAX.

        ``min_ess``: after the first ``cfg.nsteps`` samples, extend the
        chain in ``cfg.nsteps``-sample blocks (frozen step size and mass)
        until every parameter reaches ``min_ess`` effective samples or
        ``max_blocks`` blocks ran. ``checkpoint_path``/``resume``: with
        ``min_ess`` the checkpoint unit is the block; without it, ``0 <
        cfg.checkpoint_every < cfg.nsteps`` cuts the run into blocks of
        that many samples, the chain equal to the unblocked run's (the
        module's protocol), on every route.
        """
        cfg = self.cfg
        grid = self.grid
        md = MAX_DOUBLINGS
        if grid is not None:
            self._require_active()
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
        route = self._nuts_route(nchains)
        if route == "meshless":
            axis, pooled = "grid", False
        else:
            nchains = self._nuts_grid_chains(route, nchains)
            axis = "grid" if route == "replicas" else "walkers"
            pooled = {"pooled": True, "replicas": bool(pooled),
                      "stream": pooled is None or bool(pooled)}[route]
        ndim = self.layout.ndim
        nsteps = int(cfg.nsteps)
        every = int(cfg.checkpoint_every or 0)
        if min_ess:
            sizes, ck = None, npz_path(checkpoint_path)
            fp, names = self._nuts_fp(nchains, ndim, num_warmup, route=route)
            label = "nuts-min-ess"
        elif checkpoint_path and 0 < every < nsteps:
            nb = -(-nsteps // every)
            sizes = [every] * (nb - 1) + [nsteps - every * (nb - 1)]
            ck = npz_path(checkpoint_path)
            fp, names = self._nuts_fp(nchains, ndim, num_warmup, every,
                                      route=route)
            label = "nuts-checkpoint"
        else:
            sizes, ck = [nsteps], None
        loaded = (self._nuts_ckpt_load(ck, fp, names, label, generator,
                                       resume) if ck else None)
        blocks, state, ends = loaded or ([], None, [])
        post = self._nuts_post(route)
        lo, hi = self.layout.bounds_arrays(self.dtype, self.device)
        lnp_y, to_theta, to_y = make_unconstrained(post, lo, hi)
        if loaded:
            self.log.info("NUTS start guard skipped: resuming from %s "
                          "(%d blocks, %d samples; warmup skipped)"
                          % (ck, len(blocks),
                             sum(b[0].shape[0] for b in blocks)))
        else:
            y0 = self._nuts_starts(generator, nchains, lo, hi, to_y)
        self._log_nuts_route(route, pooled, nchains)

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
                run = sh.run_nuts_sharded(
                    lnp_y, y0, generator, grid, int(num_warmup), n,
                    pooled=pooled, axis=axis, max_doublings=md,
                    target_accept=float(cfg.nuts_target_accept))
                counts = run.counts
            else:
                run = sh.continue_nuts_sharded(lnp_y, state, generator,
                                               grid, n, axis=axis,
                                               max_doublings=md,
                                               counts=counts)
            state = run.state
            blocks.append((run.samples, run.lnps, run.alphas,
                           float(run.div_frac.mean())))
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
        # the fitposterior "Ln Prob" column); on a grid a collective
        lnps = self._theta_lnprob(chain_dev).double().cpu().numpy()
        chain = chain_dev.double().cpu().numpy()
        alphas = torch.cat([b[2] for b in blocks]).double().cpu().numpy()
        counts.lane_leapfrogs = float(counts.lane_leapfrogs)
        self.nuts_counts = counts
        eps = state[1].double().cpu().numpy()
        self.log.info("Total time taken: %0.2f s; step size %s; mean "
                      "accept-stat %.2f; divergent transitions %.2f%%"
                      % (elapsed, ("%.4g" % eps[0] if np.all(eps == eps[0])
                                   else "%.4g..%.4g (per replica)"
                                   % (eps.min(), eps.max())),
                         float(np.mean(alphas)), 100.0 * div_frac))
        blk = nchains // sh.nuts_axis(grid, axis)[0]
        self.log.info(
            "NUTS work: %d transitions, %d leapfrog steps (batched over "
            "%d chains), %d host syncs; leapfrogs per transition: batched "
            "mean %.2f, max %d, per chain mean %.2f"
            % (counts.transitions, counts.leapfrogs, blk, counts.syncs,
               counts.leapfrogs / max(counts.transitions, 1),
               counts.max_leapfrogs,
               counts.lane_leapfrogs / max(counts.transitions * blk, 1)))
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
