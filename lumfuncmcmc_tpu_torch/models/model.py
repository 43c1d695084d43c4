"""User-facing fit models (port of the ``fit``, ``fitz`` and ``fith``
paths of ``lumfuncmcmc_tpu/models/model.py``): :class:`LumFuncModel`,
the single-epoch model, :class:`LumFuncModelZ`, the redshift-evolving
one, and :class:`LumFuncModelH`, the hierarchical multi-field one.

They keep the public surface of the JAX classes —
``fit_model``, ``fit_model_nuts``, ``set_median_fit``, ``veff_lf``,
``add_fitinfo_to_table``, ``triangle_plot``, the model-comparison
methods ``log_evidence``, ``information_criteria`` and ``fit_map``, and
the ``samples`` / ``medianLF`` / ``Lavg`` / ``lfbinorig`` / ``var``
attributes — with tensors on one explicit device and dtype inside.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.models.context import build_context
from lumfuncmcmc_tpu_torch.models.ensemble_driver import (
    _EnsembleDriverMixin, stream_generator)
from lumfuncmcmc_tpu_torch.models.hierarchical import (
    ThetaLayoutH, lnlike_h_split, lnprior_h, lnz0_prior, make_lnprob_h)
from lumfuncmcmc_tpu_torch.models.nuts_driver import _NutsDriverMixin
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, lnlike_exact_bounds, lnlike_single_epoch, lnprior,
    make_lnprob, sample_init)
from lumfuncmcmc_tpu_torch.models.likelihood_z import (
    ThetaLayoutZ, lnlike_z, lnprior_z, make_lnprob_z)
from lumfuncmcmc_tpu_torch.ops.cuda_lnlike import FLOAT32_MAX_SOURCES
from lumfuncmcmc_tpu_torch.models.veff import (
    binned_lf_bootstrap, log_bin_edges, veff_weights)
from lumfuncmcmc_tpu_torch.ops.completeness import fleming_root_logf_np
from lumfuncmcmc_tpu_torch.ops.schechter import schechter_z, true_lum_func
from lumfuncmcmc_tpu_torch.samplers.diagnostics import (
    mcse_quantile, rank_normalized_rhat)
from lumfuncmcmc_tpu_torch.utils.logging import setup_logging


def select_samples(samples: np.ndarray, lnprobcut: float = 7.5,
                   drop_lnp: bool = False):
    """Iterative lnprob-cut selection: keep samples within ``lnprobcut``
    of the maximum, doubling the cut until at least a quarter survive."""
    lnp = samples[:, -1]
    if len(samples) < 4:
        return samples[:, :-1] if drop_lnp else samples
    if not np.any(np.isfinite(lnp)):
        raise ValueError(
            "select_samples: no sample has a finite lnprob — the "
            "chain never found a finite-posterior region")
    nsamples = np.empty((0, samples.shape[1]))
    while len(nsamples) < len(samples) // 4:
        sel = lnp > (np.nanmax(lnp) - lnprobcut)
        nsamples = samples[sel]
        lnprobcut *= 2.0
    return nsamples[:, :-1] if drop_lnp else nsamples


def posterior_lfs(model, draws):
    """Schechter phi at the catalog luminosities for each theta row of
    ``draws`` -> (ndraws, N) float64 numpy."""
    th = torch.as_tensor(np.asarray(draws), dtype=model.dtype,
                         device=model.device)
    lstar, phistar, sch_al, _, _ = model.layout.unpack(th)
    lf = true_lum_func(model.ctx.lum, sch_al[:, None], lstar[:, None],
                       phistar[:, None])
    return lf.double().cpu().numpy()


# stream tags of the model-comparison runs' generators, the JAX package's
# fold_in constants: an evidence or MAP run after a fit must not replay
# the fit's draws
EVIDENCE_TAG, MAP_TAG = 0x65766964, 0x6d6170


class _BaseModel(_EnsembleDriverMixin, _NutsDriverMixin):
    """Context build, engine choice, V_eff and the posterior table."""

    model_kind = "single"   # which kernel family the engines take

    def __init__(self, cfg: LFConfig, z, flux=None, flux_e=None,
                 lum=None, lum_e=None, field_id=None, field_names=None,
                 device=None, dtype=None):
        if device is None or dtype is None:
            # device None means the card (this rank's on a grid): the CPU
            # only when asked for
            from lumfuncmcmc_tpu_torch.cli.common import _apply_precision
            device, dtype = _apply_precision(cfg, device or "cuda")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.log = setup_logging()
        self.grid = self._make_grid()
        self.field_names = field_names
        t0 = time.time()
        self.data, self.ctx = build_context(
            cfg, z=z, flux=flux, flux_e=flux_e, lum=lum, lum_e=lum_e,
            field_id=field_id, device=self.device, dtype=dtype)
        self.log.info("Context build: %0.2f s (%d sources, grid %s, "
                      "quadrature=%s)"
                      % (time.time() - t0, len(np.asarray(z)),
                         tuple(self.ctx.logL_grid.shape), cfg.quadrature))
        self.zmin = float(np.min(np.asarray(z)))
        self.zmax = float(np.max(np.asarray(z)))
        self.layout = self._make_layout()
        self._lnprob_batch = None
        self.samples: Optional[np.ndarray] = None
        self.chain: Optional[np.ndarray] = None
        self.table = None

    def _make_layout(self):
        raise NotImplementedError

    def _make_grid(self):
        """The ``(walkers, sources)`` grid of ranks the config asks for
        (``mesh_walkers`` 0: every rank left), or with no mesh flag and a
        process group of more than one rank ``(world, 1)``, the JAX CLI's
        default over every device; None for a grid of one rank, which is
        the meshless path. On the card, rank 0 builds the kernels while
        the grid's other ranks wait."""
        from lumfuncmcmc_tpu_torch.parallel.distributed import world_size
        from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh
        cfg = self.cfg
        if not (cfg.mesh_walkers or cfg.mesh_sources > 1
                or world_size() > 1):
            return None
        grid = make_mesh(cfg.mesh_walkers, cfg.mesh_sources)
        if grid.size == 1 and grid.world == 1:
            return None
        self.log.info("Device grid: %s of %d ranks, this rank %s"
                      % (grid.shape, grid.world,
                         "idle" if grid.idle else
                         (grid.walker_index, grid.source_index)))
        if self.device.type == "cuda" and not grid.idle:
            from lumfuncmcmc_tpu_torch.ops._build import build_on_grid
            build_on_grid(grid)
        return grid

    def _require_active(self):
        """Raise on a rank the grid leaves idle."""
        if self.grid is not None and self.grid.idle:
            raise RuntimeError(
                f"rank {self.grid.rank} is idle in the {self.grid.shape} "
                f"grid of {self.grid.world} ranks: it has nothing to run")

    def _make_scalar_lnprob(self, ctx=None):
        """The eager engine's lnprob, (C, D) -> (C,), on ``ctx`` (default
        the model's): what NUTS differentiates by autograd on the CPU,
        and what the MAP fit maximizes."""
        raise NotImplementedError

    def _prior_like_fns(self):
        """``(lnprior_fn, lnlike_fn)``, each (W, D) -> (W,): the prior
        measure (box, and the hierarchical hyperprior) and the data term
        a tempered run multiplies by beta. Subclasses give the eager
        split; the hand-kernel engine takes the family's value kernel
        (:func:`~lumfuncmcmc_tpu_torch.ops.cuda_lnlike.make_cuda_prior_like`)."""
        if self._resolve_use_pallas():
            from lumfuncmcmc_tpu_torch.ops.cuda_lnlike import (
                make_cuda_prior_like)
            prior, like = make_cuda_prior_like(self.ctx, self.layout,
                                               model=self.model_kind)
        else:
            prior, like = self._eager_prior_like()
            like.engine = "eager"
        return prior, self._check_precision(like)

    def _eager_prior_like(self):
        raise NotImplementedError

    def _default_positions(self, generator):
        """Uniform draws inside the prior box. Always used by
        :meth:`log_evidence`: rungs near beta = 0 sample the prior and
        need prior-wide starts."""
        return sample_init(generator, self.layout, self.cfg.nwalkers,
                           dtype=self.dtype, device=self.device)

    def _initial_positions(self, generator):
        """Walker starts: uniform prior-box draws, or with
        ``cfg.init_map`` overdispersed Laplace draws around the MAP
        (:meth:`_map_init_positions`)."""
        if self.cfg.init_map:
            return self._map_init_positions(generator)
        self._init_from_map = False
        return self._default_positions(generator)

    def _map_init_positions(self, generator):
        """Walkers from N(MAP, 2^2 Laplace cov), each component outside
        the prior box replaced by a center-shrunk box draw. Falls back
        to uniform draws, with a warning, when the Laplace covariance is
        unusable (a mode on a box edge, or no negative definite
        Hessian); ``self._init_from_map`` records which ran, so the NUTS
        start guard shrinks only the fallback's starts."""
        if getattr(self, "map_fit", None) is None:
            self.fit_map()
        res = self.map_fit
        if not res["hess_ok"] or np.asarray(res["boundary"]).any():
            self.log.warning(
                "init_map: Laplace covariance unavailable (%s) — using "
                "uniform box starts"
                % ("MAP pinned at a prior bound" if res["hess_ok"]
                   else "Hessian not negative definite at the mode"))
            self._init_from_map = False
            return self._default_positions(generator)
        lo, hi = self.layout.bounds_arrays(self.dtype, self.device)
        n, d = self.cfg.nwalkers, self.layout.ndim
        cov = np.asarray(res["cov"])
        chol = np.linalg.cholesky(
            cov + 1e-12 * np.eye(d) * float(np.max(np.diag(cov))))
        z = torch.randn((n, d), generator=generator, dtype=self.dtype,
                        device=self.device)
        pos = (torch.as_tensor(res["theta"], dtype=self.dtype,
                               device=self.device)[None, :]
               + 2.0 * (z @ torch.as_tensor(chol, dtype=self.dtype,
                                            device=self.device).T))
        u = (0.8 * ((lo + hi) / 2.0)[None, :]
             + 0.2 * self._default_positions(generator))
        pos = torch.where((pos > lo) & (pos < hi), pos, u)
        self._init_from_map = True
        self.log.info("Walker init: %d Laplace draws around the MAP "
                      "(2x overdispersed)" % n)
        return pos

    @property
    def lum(self):
        return self.data.lum.double().cpu().numpy()

    @property
    def lum_e(self):
        return (self.data.lum_e.double().cpu().numpy()
                if self.data.lum_e is not None
                else np.zeros_like(self.lum))

    def get_param_names(self):
        return self.layout.plot_names()

    def get_params(self):
        """Current central parameter values in theta order. Also sets
        ``self.nfreeparams``."""
        cfg = self.cfg
        defaults = {"Lstar": cfg.Lstar, "phistar": cfg.phistar,
                    "sch_al": cfg.sch_al, "alpha": cfg.alpha,
                    "L1": cfg.Lstar, "L2": cfg.Lstar, "L3": cfg.Lstar,
                    "phi1": cfg.phistar, "phi2": cfg.phistar,
                    "phi3": cfg.phistar,
                    # natural z-evolution parameterization
                    "Lmid": cfg.Lstar, "Lslope": 0.0, "Lcurv": 0.0,
                    "pmid": cfg.phistar, "pslope": 0.0, "pcurv": 0.0,
                    # hierarchical hyperparameters
                    "mu_L": cfg.Lstar, "sig_L": 0.3,
                    "mu_p": cfg.phistar, "sig_p": 0.5}
        vals = []
        for name in self.layout.names:
            stem, _, idx = name.partition("_")
            if stem == "Flim":
                vals.append(cfg.Flim[int(idx)])
            elif stem in ("Lstar", "phistar") and idx:   # per-field
                vals.append(getattr(cfg, stem))
            else:
                vals.append(defaults[name])
        self.nfreeparams = len(vals)
        return vals

    @property
    def exact_bounds(self):
        """``cfg.exact_bounds`` where it applies: the single-epoch model
        under free completeness."""
        return bool(self.cfg.exact_bounds and self.model_kind == "single"
                    and not self.cfg.fix_comp)

    def _resolve_use_pallas(self):
        """``cfg.use_pallas`` names the hand-kernel engine; None means
        on for a CUDA device and off on the CPU. Exact bounds have no
        kernel: auto mode takes the eager engine, and an explicit
        ``use_pallas`` raises."""
        if self.exact_bounds:
            if self.cfg.use_pallas:
                raise ValueError(
                    "exact_bounds is not implemented in the value kernels "
                    "— drop --use-pallas (the eager exact-bounds engine "
                    "is the path for this configuration)")
            return False
        if self.cfg.use_pallas is None:
            return self.device.type == "cuda"
        return bool(self.cfg.use_pallas)

    def _log_convergence(self, chain, rhat_line=True):
        """Rank-normalized split-R-hat (bulk/tail max) and the
        Monte-Carlo SE of each parameter's posterior median."""
        if rhat_line:
            self.log.info("rank-normalized R-hat (bulk/tail max): %.4f"
                          % rank_normalized_rhat(chain).max())
        self.log.info("median MCSE per param: %s"
                      % np.array2string(mcse_quantile(chain, 0.5),
                                        precision=4))

    def lnprob_batch(self):
        """The (W, D) -> (W,) lnprob of the resolved engine: on a grid,
        the routes of ``lumfuncmcmc_tpu/models/model.py:271-320``
        (:meth:`_grid_batch`)."""
        if self._lnprob_batch is None:
            self._lnprob_batch = (self._meshless_batch() if self.grid is None
                                  else self._grid_batch())
        return self._lnprob_batch

    def _grid_batch(self):
        """The grid's lnprob: the streaming kernels on source shards for
        a catalog that takes them (``cuda_lnlike.takes_stream``) on a
        source-split grid, else the family's value kernels walker-split
        over every rank, or the eager engine split on both axes under
        ``--exact-bounds`` or ``--no-pallas``."""
        from lumfuncmcmc_tpu_torch.ops.cuda_lnlike import takes_stream
        from lumfuncmcmc_tpu_torch.parallel import sharding as sh
        self._require_active()
        g = self.grid
        if self._resolve_use_pallas():
            if g.n_sources > 1 and takes_stream(
                    self.model_kind, self.cfg.fix_comp,
                    int(self.ctx.lum.shape[0])):
                fn = sh.make_cuda_lnprob_stream_sharded(self.ctx, self.layout,
                                                        g)
                self.log.info(
                    "Engine: %s, sources round-robin sharded over %d ranks "
                    "x walkers over %d"
                    % ("CUDA streaming kernels" if fn.engine == "cuda-stream"
                       else "plain versions of the streaming kernels",
                       g.n_sources, g.n_walkers))
            else:
                fn = sh.make_cuda_lnprob_sharded(self.ctx, self.layout, g,
                                                 model=self.model_kind)
                self.log.info("Engine: %s, walker-sharded over the %d-rank "
                              "grid" % ("CUDA value kernels"
                                        if fn.engine.startswith("cuda")
                                        else "plain versions of the value "
                                             "kernels", g.size))
            return self._check_precision(fn)
        fn = sh.make_lnprob_sharded(
            self.ctx, self.layout, g, model=self.model_kind,
            exact_bounds=self.exact_bounds,
            min_comp_frac=self.cfg.min_comp_frac, lh=self.cfg.Lh)
        fn.engine = "eager"
        self.log.info("Engine: eager, walkers over %d ranks x sources over "
                      "%d" % (g.n_walkers, fn.source_shards))
        return self._check_precision(fn)

    def _meshless_batch(self):
        if self._resolve_use_pallas():
            from lumfuncmcmc_tpu_torch.ops import cuda_lnlike
            make = {"single": cuda_lnlike.make_cuda_lnprob,
                    "z": cuda_lnlike.make_cuda_lnprob_z,
                    "hier": cuda_lnlike.make_cuda_lnprob_h}
            return self._check_precision(make[self.model_kind](
                self.ctx, self.layout))
        fn = self._make_scalar_lnprob()
        fn.engine = "eager"
        self._check_precision(fn)
        return fn

    def _check_precision(self, fn):
        """Log the streaming engine, where ``fn`` takes it (free
        completeness from ``STREAM_MIN_SOURCES`` sources on), and refuse
        a run that is not float64 where its lnp cannot resolve the
        accept step: from ``FLOAT32_MAX_SOURCES`` sources on, for every
        family and engine (the float32 spacing of |lnL| ~ 15 N then
        passes the 0.05 that the lnp difference of two close thetas can
        bear), and on the streaming route at any size. Returns ``fn``.
        The count is the whole catalog's on a grid too (the model's context
        is whole; only the sharded lnprob holds shards)."""
        n = int(self.ctx.lum.shape[0])
        stream = hasattr(fn, "stream")
        if stream:
            self.log.info("Engine: %s (%d sources, %d tiles)" % (
                "CUDA streaming kernels" if fn.engine == "cuda-stream"
                else "plain versions of the streaming kernels", n,
                fn.stream[1]))
        if self.dtype != torch.float64 and (stream
                                            or n >= FLOAT32_MAX_SOURCES):
            raise ValueError(
                "%d sources need a float64 lnprob (a %s one cannot "
                "resolve the accept step at |lnL| ~ %.0e): set use_x64 "
                "(a --config file with {\"use_x64\": true})"
                % (n, str(self.dtype).replace("torch.", ""), 15.0 * n))
        return fn

    def log_evidence(self, nrungs: int = 16, nsteps: int = None,
                     generator=None, power: float = 5.0, move: str = None,
                     burn_frac: float = 0.5, swap_every: int = 0,
                     tune_rounds: int = 0, tune_steps: int = None):
        """ln Z of this model under its normalized prior by the tempered
        ladder (:mod:`~lumfuncmcmc_tpu_torch.samplers.tempering`): all
        ``nrungs`` rungs sample at once, one lnlike call a half-step over
        rungs x walkers/2 rows. ``swap_every > 0`` adds DEO replica
        exchange; ``tune_rounds > 0`` (with swaps) prepends that many
        short legs (``tune_steps``, default nsteps//4 in whole swap
        rounds) after each of which the ladder is re-spaced to equalize
        the measured swap rejection. ``generator`` defaults to one
        seeded off the fit's stream; the starts are always prior-box
        draws. On a grid whole rungs go one or more to a rank
        (:func:`~lumfuncmcmc_tpu_torch.parallel.sharding.run_tempered_sharded`,
        ``run_parallel_tempering_sharded``: the meshless ladder's run), K
        rounded up to a multiple of the ranks. Returns the estimator dict
        (``lnz_ss`` primary, ``lnz_ti`` the resolution check), also stored
        as ``self.evidence``.
        """
        from lumfuncmcmc_tpu_torch.models.ensemble_driver import _sync
        from lumfuncmcmc_tpu_torch.samplers.tempering import (
            barrier_stats, beta_ladder, evidence_from_ladder,
            run_parallel_tempering, run_tempered, tune_ladder)
        cfg = self.cfg
        nsteps = int(nsteps or cfg.nsteps)
        move = move or cfg.move
        if tune_rounds and not swap_every:
            raise ValueError("tune_rounds needs swap_every > 0 (the "
                             "ladder is tuned from measured swap rates)")
        grid = self.grid
        if grid is not None:
            self._require_active()
            if nrungs % grid.size:
                # whole rungs a rank; rounding up buys ladder resolution
                new = -(-nrungs // grid.size) * grid.size
                self.log.info("Rounding evidence rungs %d -> %d (multiple "
                              "of the %d-rank grid)" % (nrungs, new,
                                                        grid.size))
                nrungs = new
            from lumfuncmcmc_tpu_torch.parallel.sharding import (
                run_parallel_tempering_sharded, run_tempered_sharded)

            def run_parallel_tempering(*a, **kw):
                return run_parallel_tempering_sharded(*a[:6], grid, **kw)

            def run_tempered(*a, **kw):
                return run_tempered_sharded(*a[:6], grid, **kw)
        if generator is None:
            generator = stream_generator(cfg.seed, EVIDENCE_TAG, self.device)
        pos0 = torch.stack([self._default_positions(generator)
                            for _ in range(nrungs)])
        betas = beta_ladder(nrungs, power)
        lnprior_fn, lnlike_fn = self._prior_like_fns()
        self.log.info(
            "Evidence ladder: %d rungs x %d walkers x %d steps "
            "(power-%g spacing), move=%s%s"
            % (nrungs, cfg.nwalkers, nsteps, power, move,
               "" if grid is None
               else ", rungs sharded over %d ranks" % grid.size))
        _sync(self.device)
        start = time.perf_counter()
        swap_frac = None
        if swap_every and int(tune_rounds) > 0:
            n_tune = int(tune_steps or max(int(swap_every) * 4,
                                           nsteps // 4))
            n_tune = max(int(swap_every), n_tune - n_tune % int(swap_every))
            for t in range(int(tune_rounds)):
                ch_t, _, _, sw_t = run_parallel_tempering(
                    lnprior_fn, lnlike_fn, pos0, betas, generator, n_tune,
                    swap_every=int(swap_every), move=move,
                    de_prob=cfg.de_prob, lnls=False)
                betas = tune_ladder(betas, sw_t)
                # walkers carry over; burn_frac absorbs the transient
                pos0 = ch_t[:, -1]
                self.log.info(
                    "Ladder tuning leg %d/%d (%d steps): swap acceptance "
                    "%s -> re-spaced betas (min dβ %.2e)"
                    % (t + 1, int(tune_rounds), n_tune,
                       np.round(sw_t, 2), float(np.min(np.diff(betas)))))
        if swap_every:
            _, lnls, _, swap_frac = run_parallel_tempering(
                lnprior_fn, lnlike_fn, pos0, betas, generator, nsteps,
                swap_every=int(swap_every), move=move, de_prob=cfg.de_prob)
            self.log.info("Replica-exchange swap acceptance per pair: %s"
                          % np.round(swap_frac, 2))
        else:
            _, lnls, _ = run_tempered(lnprior_fn, lnlike_fn, pos0, betas,
                                      generator, nsteps, move=move,
                                      de_prob=cfg.de_prob)
        lnls = lnls.double().cpu().numpy()
        elapsed = time.perf_counter() - start
        ev = evidence_from_ladder(lnls, betas, burn_frac=burn_frac)
        if swap_frac is not None:
            ev["swap_frac"] = swap_frac
            bs = barrier_stats(swap_frac)
            ev["lambda_barrier"] = bs["lambda"]
            ev["roundtrip_rate_est"] = bs["roundtrip_rate"]
            self.log.info(
                "Communication barrier Λ = %.2f -> estimated DEO "
                "round-trip rate %.3f per replica sweep-pair (Syed et al. "
                "2021 Cor. 1; low rate with uneven swap acceptance -> "
                "tune the ladder, uniformly low -> raise nrungs)"
                % (bs["lambda"], bs["roundtrip_rate"]))
        self.log.info(
            "ln Z = %.3f +- %.3f (stepping-stone; TI %.3f +- %.3f; "
            "|SS-TI| %.3f is the ladder-resolution check) in %.2f s"
            % (ev["lnz_ss"], ev["lnz_ss_err"], ev["lnz_ti"],
               ev["lnz_ti_err"], abs(ev["lnz_ss"] - ev["lnz_ti"]), elapsed))
        gap = abs(ev["lnz_ss"] - ev["lnz_ti"])
        if gap > 3.0 * (ev["lnz_ss_err"] + ev["lnz_ti_err"]) + 2.0:
            self.log.warning(
                "evidence ladder looks UNDER-RESOLVED: |SS-TI| = %.1f nats "
                "exceeds the combined MC error band — raise nrungs (SS "
                "should move < O(1) nats between K and 2K rungs before "
                "you trust a Bayes factor); high-dimensional priors (fith) "
                "typically need several times the default ladder" % gap)
        self.evidence = ev
        return ev

    def information_criteria(self, lnprobcut: float = 7.5,
                             ndraws: int = 1000, seed: int = None,
                             chunk: int = 8192):
        """WAIC + PSIS-LOO from the fitted posterior's ``select_samples``
        rows (:mod:`~lumfuncmcmc_tpu_torch.models.ic`), logged, checked
        against the likelihood's own split and stored as ``self.ic``."""
        from lumfuncmcmc_tpu_torch.models.ic import (
            format_ic_report, information_criteria)
        if self.samples is None:
            raise RuntimeError("fit the model before computing "
                               "information criteria")
        cfg = self.cfg
        draws = select_samples(self.samples, lnprobcut, drop_lnp=True)
        t0 = time.perf_counter()
        ic = information_criteria(
            draws, self.ctx, self.layout, exact_bounds=self.exact_bounds,
            min_comp_frac=cfg.min_comp_frac, lh=cfg.Lh, ndraws=int(ndraws),
            seed=cfg.seed if seed is None else int(seed), chunk=int(chunk))
        for line in format_ic_report(ic).splitlines():
            self.log.info(line)
        self.log.info("Information criteria: %.2f s" %
                      (time.perf_counter() - t0))
        # the decomposition is exact; above float noise means a dispatch
        # bug. float32 roundoff accumulates over the N-source resummation
        tol = (1e-5 if self.dtype == torch.float64
               else max(1e-4, 3e-7 * math.sqrt(ic["n_sources"])))
        if ic["max_abs_recon_err"] > tol:
            self.log.warning(
                "pointwise decomposition check FAILED (%.2e) — the "
                "WAIC/LOO numbers do not match this model's likelihood"
                % ic["max_abs_recon_err"])
        if ic["frac_k_gt_07"] > 0.1:
            self.log.warning(
                "PSIS tail diagnostic: %.1f%% of sources have Pareto k > "
                "0.7 — elpd_loo is unreliable; trust elpd_waic only as "
                "far as p_waic is small" % (100.0 * ic["frac_k_gt_07"]))
        self.ic = ic
        return ic

    def rebuild_context(self, cfg, dtype):
        """A context of this catalog for ``cfg`` in ``dtype`` on the
        model's device, rebuilt from the luminosities (``LFData.flux`` is
        absolute cgs while ``build_context`` takes 1e-17 units)."""
        d = self.data

        def host(a):
            return None if a is None else a.double().cpu().numpy()
        return build_context(cfg, z=host(d.z), lum=host(d.lum),
                             lum_e=host(d.lum_e),
                             field_id=d.field_id.cpu().numpy(),
                             device=self.device, dtype=dtype)[1]

    def context64(self):
        """The model's context in float64: itself on a float64 run, else
        rebuilt."""
        if self.dtype == torch.float64:
            return self.ctx
        return self.rebuild_context(self.cfg, torch.float64)

    def fit_map(self, nstarts: int = 8, generator=None, maxiter: int = 500):
        """MAP + Laplace quick-look fit
        (:func:`~lumfuncmcmc_tpu_torch.models.mapfit.laplace_fit`) of the
        eager float64 lnpost, with ``lnz_laplace`` in
        :meth:`log_evidence`'s normalized-prior convention: ``- ln V``
        of the box, or for the hierarchical model ``- lnz0_prior``, the
        box-truncated hyperprior mass. ``generator`` defaults to one
        seeded off the fit's stream. Stored as ``self.map_fit``."""
        from lumfuncmcmc_tpu_torch.models.mapfit import laplace_fit
        cfg = self.cfg
        if generator is None:
            generator = stream_generator(cfg.seed, MAP_TAG, self.device)
        lnpost = self._make_scalar_lnprob(self.context64())
        lo, hi = self.layout.bounds_arrays(torch.float64, self.device)
        t0 = time.perf_counter()
        res = laplace_fit(lnpost, lo, hi, generator=generator,
                          nstarts=int(nstarts), maxiter=int(maxiter))
        elapsed = time.perf_counter() - t0
        if res["ln_int"] is not None and self.model_kind == "hier":
            res["lnz_laplace"] = res["ln_int"] - lnz0_prior(self.layout)
        elif res["ln_int"] is not None:
            res["lnz_laplace"] = res["ln_int"] - float(np.sum(np.log(
                np.asarray(self.layout.hi, np.float64)
                - np.asarray(self.layout.lo, np.float64))))
        else:
            res["lnz_laplace"] = None
        se = res["se"]
        self.log.info("MAP fit: lnpost=%.4f in %.2f s (%d/%d starts "
                      "finite, |grad|=%.2e%s)"
                      % (res["lnpost"], elapsed, res["n_finite"],
                         res["nstarts"], res["grad_norm"],
                         "" if res["hess_ok"]
                         else "; Hessian NOT negative definite — no "
                              "Laplace covariance"))
        for i, name in enumerate(self.layout.names):
            if res["boundary"][i]:
                tail = ("  (AT PRIOR BOUND — no Laplace error; widen the "
                        "box if this parameter should be free)")
            elif se is not None and np.isfinite(se[i]):
                tail = " +- %.4f" % se[i]
            else:
                tail = ""
            self.log.info("  %-12s = %10.4f%s"
                          % (name, res["theta"][i], tail))
        if res["lnz_laplace"] is not None:
            self.log.info("  Laplace ln Z = %.3f (cross-check "
                          "log_evidence's stepping-stone)"
                          % res["lnz_laplace"])
        self.map_fit = res
        return res

    def veff_lf(self, flim=None, alpha=None, generator=None):
        """1/V_eff binned LF with bootstrap errors; sets ``phifunc``,
        ``Lavg``, ``lfbinorig`` and ``var``."""
        cfg = self.cfg
        flim = np.asarray(flim if flim is not None else cfg.Flim,
                          dtype=np.float64)
        alpha = float(alpha if alpha is not None else cfg.alpha)
        logF50 = np.log10(flim) - 17.0
        if cfg.min_comp_frac > 0.001:
            roots = fleming_root_logf_np(logF50, alpha, cfg.min_comp_frac,
                                         cfg.fcmin)
        else:
            roots = np.full(len(flim), -np.inf)
        fid = self.ctx.field_id

        def per_src(a):
            return torch.as_tensor(a, dtype=self.dtype,
                                   device=self.device)[fid]

        w = veff_weights(
            self.ctx.logf_src, self.ctx.lum, per_src(logF50),
            per_src(roots), float(np.sum(cfg.Omega_0)), self.zmin,
            self.zmax, torch.tensor(alpha, dtype=self.dtype,
                                    device=self.device),
            self.ctx.cosmo, cfg.fcmin, cfg.min_comp_frac)
        edges = log_bin_edges(self.ctx.lum, cfg.nbins)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(cfg.seed + 1)
        lavg, lfbin, var = binned_lf_bootstrap(
            generator, self.ctx.lum, w, edges, cfg.nboot, cfg.nbins)
        self.phifunc = w.double().cpu().numpy()
        self.Lavg = lavg.double().cpu().numpy()
        self.lfbinorig = lfbin.double().cpu().numpy()
        self.var = var.double().cpu().numpy()
        return self.Lavg, self.lfbinorig, self.var

    def VeffLF(self):
        """The reference's name for :meth:`veff_lf`."""
        return self.veff_lf()

    def add_fitinfo_to_table(self, percentiles, start_value=1,
                             lnprobcut=7.5):
        """Fill the percentile columns of ``self.table`` row -1."""
        nsamples = select_samples(self.samples, lnprobcut, drop_lnp=True)
        n = len(percentiles)
        for i, per in enumerate(percentiles):
            for j, v in enumerate(np.percentile(nsamples, per, axis=0)):
                self.table[-1][i + start_value + j * n] = v
        return self.table


class LumFuncModel(_BaseModel):
    """Single-epoch Schechter fit (reference ``LumFuncMCMC``)."""

    def _make_layout(self):
        return ThetaLayout.from_config(self.cfg)

    def _make_scalar_lnprob(self, ctx=None):
        return make_lnprob(self.ctx if ctx is None else ctx, self.layout,
                           exact_bounds=self.exact_bounds,
                           min_comp_frac=self.cfg.min_comp_frac,
                           lh=self.cfg.Lh)

    def _eager_prior_like(self):
        ctx, layout, cfg = self.ctx, self.layout, self.cfg
        if self.exact_bounds:
            lum_floor = float(ctx.lum.min())

            def like(th):
                return lnlike_exact_bounds(th, ctx, layout,
                                           cfg.min_comp_frac, lum_floor,
                                           cfg.Lh)
        else:
            def like(th):
                return lnlike_single_epoch(th, ctx, layout)
        return (lambda th: lnprior(th, layout)), like

    def _default_positions(self, generator):
        # only the single-epoch model has the reference's -sr/--same_rand
        return sample_init(generator, self.layout, self.cfg.nwalkers,
                           diff_rand=self.cfg.diff_rand, dtype=self.dtype,
                           device=self.device)

    def set_median_fit(self, rndsamples=200, lnprobcut=7.5, generator=None):
        """Median model LF over posterior draws + V_eff with the median
        completeness parameters."""
        nsamples = select_samples(self.samples, lnprobcut)
        self.log.info("Shape of nsamples (with a lnprobcut applied)")
        self.log.info(str(nsamples.shape))
        rng = np.random.default_rng(self.cfg.seed + 2)
        idx = rng.integers(0, nsamples.shape[0], rndsamples)
        draws = nsamples[idx, :-1]
        self.medianLF = np.median(posterior_lfs(self, draws), axis=0)
        th = torch.as_tensor(draws, dtype=torch.float64)
        _, _, _, logf50, alpha_c = self.layout.unpack(th)
        self.median_flim = np.median((10.0 ** (logf50 + 17.0)).numpy(),
                                     axis=0)
        self.median_alpha = float(np.median(alpha_c.numpy()))
        self.veff_lf(flim=self.median_flim, alpha=self.median_alpha,
                     generator=generator)
        return self.medianLF

    def triangle_plot(self, outname, lnprobcut=7.5, imgtype="png"):
        from lumfuncmcmc_tpu_torch.utils.plotting import triangle_plot_single
        triangle_plot_single(self, outname, lnprobcut, imgtype)


class LumFuncModelH(_BaseModel):
    """Hierarchical multi-field joint fit (see ``models/hierarchical.py``).
    Completeness fixed, like the z model."""

    model_kind = "hier"

    def __init__(self, cfg: LFConfig, *args, **kw):
        super().__init__(cfg.replace(fix_comp=True), *args, **kw)

    def _make_layout(self):
        return ThetaLayoutH.from_config(self.cfg)

    def _make_scalar_lnprob(self, ctx=None):
        return make_lnprob_h(self.ctx if ctx is None else ctx, self.layout)

    def _eager_prior_like(self):
        # the population hyperprior belongs to the prior measure: only
        # the per-field Poisson terms are tempered
        ctx, layout = self.ctx, self.layout

        def prior(th):
            lp = lnprior_h(th, layout)
            _, hyper = lnlike_h_split(th, ctx, layout)
            return torch.where(torch.isfinite(lp), lp + hyper, lp)

        def like(th):
            return lnlike_h_split(th, ctx, layout)[0]
        return prior, like

    def set_median_fit(self, rndsamples=200, lnprobcut=7.5, generator=None):
        """Median LF at the population-mean parameters (``mu_L``,
        ``mu_p``) over posterior draws, plus the V_eff cross-check."""
        nsamples = select_samples(self.samples, lnprobcut)
        rng = np.random.default_rng(self.cfg.seed + 2)
        idx = rng.integers(0, nsamples.shape[0], rndsamples)
        th = torch.as_tensor(nsamples[idx, :-1], dtype=self.dtype,
                             device=self.device)
        mu_l, _, mu_p, _, sch_al, _, _ = self.layout.unpack(th)
        lf = true_lum_func(self.ctx.lum, sch_al[:, None], mu_l[:, None],
                           mu_p[:, None])
        self.medianLF = np.median(lf.double().cpu().numpy(), axis=0)
        self.veff_lf(generator=generator)
        return self.medianLF

    def triangle_plot(self, outname, lnprobcut=7.5, imgtype="png"):
        from lumfuncmcmc_tpu_torch.utils.plotting import _pyplot, corner_plot
        plt = _pyplot()
        self.set_median_fit(lnprobcut=lnprobcut)  # artifacts downstream
        nsamples = select_samples(self.samples, lnprobcut)
        fig = corner_plot(nsamples[:, :-1], self.get_param_names())
        fig.savefig(f"{outname}.{imgtype}", dpi=200)
        plt.close(fig)


class LumFuncModelZ(_BaseModel):
    """Redshift-evolving Schechter fit (reference ``LumFuncMCMCz``)."""

    model_kind = "z"

    def __init__(self, cfg: LFConfig, *args, **kw):
        # the z model always uses the fixed-completeness grid
        super().__init__(cfg.replace(fix_comp=True), *args, **kw)

    def _make_layout(self):
        return ThetaLayoutZ.from_config(self.cfg)

    def _make_scalar_lnprob(self, ctx=None):
        return make_lnprob_z(self.ctx if ctx is None else ctx, self.layout)

    def _eager_prior_like(self):
        ctx, layout = self.ctx, self.layout
        return ((lambda th: lnprior_z(th, layout)),
                (lambda th: lnlike_z(th, ctx, layout)))

    def set_median_fit(self, lnprobcut=7.5, zlen=100, Llen=100,
                       generator=None):
        """Median-theta LF *matrix* over (z, L): sets ``zout`` (zlen,),
        ``Lout`` (Llen,) and ``medianLF`` (zlen, Llen), then V_eff."""
        nsamples = select_samples(self.samples, lnprobcut, drop_lnp=True)
        med = torch.as_tensor(np.percentile(nsamples, 50.0, axis=0),
                              dtype=torch.float64)[None, :]
        piv = [float(v) for v in self.layout.unpack(med)]
        lum = self.lum
        self.Lout = np.linspace(lum.min() - 0.2, lum.max() + 0.2, Llen)
        self.zout = np.linspace(self.zmin, self.zmax, zlen)
        zz, ll = np.meshgrid(self.zout, self.Lout, indexing="ij")
        self.medianLF = schechter_z(
            torch.as_tensor(ll), torch.as_tensor(zz), piv[6], *piv[:6],
            self.layout.z1, self.layout.z2, self.layout.z3).numpy()
        self.veff_lf(generator=generator)
        return self.medianLF

    def triangle_plot(self, outname, lnprobcut=7.5, imgtype="png"):
        from lumfuncmcmc_tpu_torch.utils.plotting import triangle_plot_z
        triangle_plot_z(self, outname, lnprobcut, imgtype)
