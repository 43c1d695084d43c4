"""User-facing fit models (port of the ``fit``, ``fitz`` and ``fith``
paths of ``lumfuncmcmc_tpu/models/model.py``): :class:`LumFuncModel`,
the single-epoch model, :class:`LumFuncModelZ`, the redshift-evolving
one, and :class:`LumFuncModelH`, the hierarchical multi-field one.

They keep the public surface of the JAX classes —
``fit_model``, ``fit_model_nuts``, ``set_median_fit``, ``veff_lf``,
``add_fitinfo_to_table``, ``triangle_plot`` and the ``samples`` /
``medianLF`` / ``Lavg`` / ``lfbinorig`` / ``var`` attributes — with
tensors on one explicit device and dtype inside.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.models.context import build_context
from lumfuncmcmc_tpu_torch.models.ensemble_driver import _EnsembleDriverMixin
from lumfuncmcmc_tpu_torch.models.hierarchical import (
    ThetaLayoutH, make_lnprob_h)
from lumfuncmcmc_tpu_torch.models.nuts_driver import _NutsDriverMixin
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, make_lnprob, sample_init)
from lumfuncmcmc_tpu_torch.models.likelihood_z import (
    ThetaLayoutZ, make_lnprob_z)
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


# flags whose features the port does not have yet, and the config value
# that means "off"
_NOT_PORTED = {"init_map": False,
               "exact_bounds": False, "mesh_walkers": 0,
               "mesh_sources": 1, "checkpoint_every": 0}


class _BaseModel(_EnsembleDriverMixin, _NutsDriverMixin):
    """Context build, engine choice, V_eff and the posterior table."""

    model_kind = "single"   # which kernel family the engines take

    def __init__(self, cfg: LFConfig, z, flux=None, flux_e=None,
                 lum=None, lum_e=None, field_id=None, field_names=None,
                 device=None, dtype=None):
        for name, off in _NOT_PORTED.items():
            if getattr(cfg, name) != off:
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r} is not ported yet "
                    "(run it with the JAX package, lumfuncmcmc_tpu)")
        if device is None or dtype is None:
            # device None means the card: the CPU only when asked for
            from lumfuncmcmc_tpu_torch.cli.common import _apply_precision
            device, dtype = _apply_precision(cfg, device or "cuda")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.log = setup_logging()
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

    def _make_scalar_lnprob(self):
        """The eager engine's lnprob, (C, D) -> (C,): what NUTS
        differentiates by autograd on the CPU."""
        raise NotImplementedError

    def _initial_positions(self, generator, diff_rand=True):
        """Walker starts: uniform draws inside the prior box."""
        return sample_init(generator, self.layout, self.cfg.nwalkers,
                           diff_rand=diff_rand, dtype=self.dtype,
                           device=self.device)

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

    def _resolve_use_pallas(self):
        """``cfg.use_pallas`` names the hand-kernel engine; None means
        on for a CUDA device and off on the CPU."""
        if self.cfg.use_pallas is None:
            return self.device.type == "cuda"
        return bool(self.cfg.use_pallas)

    def _log_convergence(self, chain):
        """Rank-normalized split-R-hat (bulk/tail max) and the
        Monte-Carlo SE of each parameter's posterior median."""
        self.log.info("rank-normalized R-hat (bulk/tail max): %.4f"
                      % rank_normalized_rhat(chain).max())
        self.log.info("median MCSE per param: %s"
                      % np.array2string(mcse_quantile(chain, 0.5),
                                        precision=4))

    def lnprob_batch(self):
        """The (W, D) -> (W,) lnprob of the resolved engine."""
        if self._lnprob_batch is None:
            self._lnprob_batch = self._meshless_batch()
        return self._lnprob_batch

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
        bear), and on the streaming route at any size. Returns ``fn``."""
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

    def _make_scalar_lnprob(self):
        return make_lnprob(self.ctx, self.layout)

    def _initial_positions(self, generator):
        # only the single-epoch model has the reference's -sr/--same_rand
        return super()._initial_positions(generator,
                                          diff_rand=self.cfg.diff_rand)

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

    def _make_scalar_lnprob(self):
        return make_lnprob_h(self.ctx, self.layout)

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

    def _make_scalar_lnprob(self):
        return make_lnprob_z(self.ctx, self.layout)

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
