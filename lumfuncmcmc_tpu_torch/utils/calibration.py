"""Calibration replicates: frequentist coverage and SBC ranks (port of
``lumfuncmcmc_tpu/utils/calibration.py``).

One replicate draws a truth, generates a synthetic catalog from it, runs
the full fit (context build, likelihood engine, stretch sampler, burn-in
rule) and scores the posterior against the truth:

- interval coverage: does the central 68%/95% posterior interval contain
  the truth? Nominal rates need every layer of the stack to be unbiased.
- SBC ranks (Talts et al. 2018): with the truth drawn FROM the fitting
  prior, its rank among M thinned posterior draws is exactly uniform on
  {0..M}; a systematic posterior bias shows as a non-uniform histogram.

The engine is the model's (:class:`~lumfuncmcmc_tpu_torch.models.model.
LumFuncModel` and its z and hierarchical twins): on the card the family's
hand-written CUDA value kernel with a float32 context, on the CPU the
float64 eager engine, and ``coverage_replicate(pallas=True)`` the value
kernel's route anywhere (its plain version on the CPU). ``device=None``
means the card; the CPU runs only with ``device="cpu"``.

Each replicate is setup, run, score. The numpy ``rng`` is consumed in the
JAX package's order (the truth first, the walker picks after the fit), so
one ``default_rng(seed)`` gives both packages the same truths and picks.
The walker starts and the sampler's draws come from ``torch.Generator``s
seeded with the JAX package's key integers. The run step is
:func:`_run`, which tests replace to feed pre-drawn randoms.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.config import (
    LFConfig, _DEFAULT_FLIM, _DEFAULT_OMEGA_0)
from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH
from lumfuncmcmc_tpu_torch.models.likelihood import sample_init
from lumfuncmcmc_tpu_torch.models.model import (
    LumFuncModel, LumFuncModelH, LumFuncModelZ)
from lumfuncmcmc_tpu_torch.parallel.sharding import pad_sources
from lumfuncmcmc_tpu_torch.samplers.affine import run_stretch
from lumfuncmcmc_tpu_torch.samplers.diagnostics import burnin_steps
from lumfuncmcmc_tpu_torch.utils.logging import setup_logging
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

PARAMS = ("Lstar", "phistar", "sch_al")

# SBC prior box: the GENERATING prior must equal the FITTING prior (a
# mismatch voids the rank-uniformity theorem), and catalogs keep their
# physical normalization (n_target=None: a rescale would silently change
# the phistar the posterior estimates)
SBC_BOX = {"Lstar_lims": (42.3, 42.7), "phistar_lims": (-2.9, -2.3),
           "sch_al_lims": (-1.8, -1.4)}

# hier SBC field boxes: the single-epoch gate's box, so retuning SBC_BOX
# moves both gates; the sig boxes come from ThetaLayoutH.from_config
HIER_BOX = dict(SBC_BOX)


def _interval_coverage(post, names, truth):
    """(in68, in95) per parameter name from flat posterior draws."""
    cover = {}
    for i, name in enumerate(names):
        lo68, hi68 = np.percentile(post[:, i], [16, 84])
        lo95, hi95 = np.percentile(post[:, i], [2.5, 97.5])
        cover[name] = (bool(lo68 <= truth[name] <= hi68),
                       bool(lo95 <= truth[name] <= hi95))
    return cover


def _thinned_ranks(post, tau, M, rng, tvec):
    """Rank of ``tvec`` (ndim,) among ``M`` draws of the post-burn chain
    ``post`` (steps, walkers, ndim): distinct walkers (``rng.choice``),
    steps >= 2 tau apart and never wrapping onto one step (same-step
    draws of an interacting ensemble are strongly correlated and would
    bias the histogram). Returns (ndim,) ints in 0..M."""
    gap = max(min(int(2 * tau), post.shape[0] // M), 1)
    steps = gap * np.arange(M)
    if steps[-1] >= post.shape[0]:
        raise ValueError(f"{post.shape[0]} post-burn steps cannot give "
                         f"{M} distinct thinned draws")
    walkers = rng.choice(post.shape[1], size=M, replace=False)
    draws = post[steps, walkers]                          # (M, ndim)
    return (draws < tvec[None, :]).sum(axis=0)


def _draw_hier_truth(rng, layout, block=4096):
    """Exact draw from the hierarchical fitting prior by rejection:
    hypers uniform in their boxes, field params ~ N(mu, sig), accepted
    only if every field param lands inside its box. The accepted density
    is the box-masked ``uniform(hyper) x prod_f N(field | hyper)``
    measure ``make_lnprob_h`` samples; an SBC truth from any other
    density voids the rank-uniformity theorem."""
    lo = np.asarray(layout.lo, np.float64)
    hi = np.asarray(layout.hi, np.float64)
    F = layout.nfields
    kf = 4 + (0 if layout.fix_sch_al else 1)
    for _ in range(64):
        mu_l = rng.uniform(lo[0], hi[0], block)
        sig_l = rng.uniform(lo[1], hi[1], block)
        mu_p = rng.uniform(lo[2], hi[2], block)
        sig_p = rng.uniform(lo[3], hi[3], block)
        ls = rng.normal(mu_l[:, None], sig_l[:, None], (block, F))
        ps = rng.normal(mu_p[:, None], sig_p[:, None], (block, F))
        ok = (np.all((ls > lo[kf]) & (ls < hi[kf]), axis=1)
              & np.all((ps > lo[kf + F]) & (ps < hi[kf + F]), axis=1))
        idx = np.flatnonzero(ok)
        if idx.size:
            i = idx[0]
            th = [mu_l[i], sig_l[i], mu_p[i], sig_p[i]]
            if not layout.fix_sch_al:
                th.append(rng.uniform(lo[4], hi[4]))
            return np.asarray(th + list(ls[i]) + list(ps[i]))
    raise RuntimeError("hier prior rejection sampler starved")


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def _model(cls, cfg, cat, device, pad=None):
    """The family's model of the catalog ``cat`` (dict or per-field
    arrays already joined), its sources padded to a multiple of ``pad``
    (masked rows: the likelihood is unchanged), and its lnprob built:
    the kernel data are setup, not sampling."""
    model = cls(cfg, z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
                field_id=cat["field_id"], device=device)
    if pad:
        model.ctx = pad_sources(model.ctx, int(pad))
    model.lnprob_batch()
    return model


def _uniform_start(model, seed):
    """Uniform prior-box starts from the generator seeded with ``seed``
    (the JAX package's ``PRNGKey(seed)`` draw)."""
    return sample_init(_generator(seed, model.device), model.layout,
                       model.cfg.nwalkers, dtype=model.dtype,
                       device=model.device)


def _run(lnprob, pos0, generator, nsteps, move="stretch"):
    """A replicate's sampling step: :func:`run_stretch` from ``pos0``
    with ``generator``'s draws. Returns the chain (nsteps, W, D) on the
    host."""
    _, chain, _, _ = run_stretch(lnprob, pos0, generator, nsteps, move=move)
    return chain.cpu().numpy()


def _sample(model, pos0, seed, move="stretch"):
    """:func:`_run` with the generator seeded with ``seed``, then the
    burn-in rule. Returns (chain, burn, tau, sampling seconds)."""
    t0 = time.perf_counter()
    nsteps = model.cfg.nsteps
    chain = _run(model.lnprob_batch(), pos0, _generator(seed, model.device),
                 nsteps, move)
    burn, tau = burnin_steps(chain, nsteps)
    return chain, burn, tau, time.perf_counter() - t0


def _log_split(what, k, nsrc, setup_s, run_s, engine):
    setup_logging().info(
        "calibration %s replicate %d: %d sources, setup %.3f s, sampling "
        "%.3f s (%s engine)" % (what, k, nsrc, setup_s, run_s, engine))


def _sbc_setup(k, rng, nwalkers, nsteps, box, size_ln, device):
    """:func:`sbc_replicate`'s truth (drawn from ``rng``), model and
    starts."""
    box = dict(SBC_BOX if box is None else box)
    truth = {nm: rng.uniform(*box[nm + "_lims"]) for nm in PARAMS}
    kw = {} if size_ln is None else {"size_ln": int(size_ln)}
    cfg = LFConfig(min_comp_frac=0.5, fix_comp=True, quadrature="gauss",
                   nwalkers=nwalkers, nsteps=nsteps, seed=k, **box,
                   **truth, **kw)
    cat = apply_completeness_cut(
        make_catalog(cfg, n_target=None, seed=1000 + k, lum_err_dex=0.0),
        cfg)
    model = _model(LumFuncModel, cfg, cat, device)
    return model, _uniform_start(model, 2000 + k), truth, len(cat["z"])


def sbc_replicate(k, rng, nwalkers=64, nsteps=600, M=7, box=None,
                  size_ln=None, device=None):
    """One SBC replicate: truth ~ prior box, physical-normalization
    catalog, full stretch fit of the fixed-completeness model, rank of
    the truth among ``M`` thinned posterior draws
    (:func:`_thinned_ranks`).

    Returns ``(ranks (ndim,), cover {name: (in68, in95)}, nsrc, tau)``:
    the truth-from-prior draw makes the interval coverage a valid
    frequentist check of the same fit, so one replicate feeds both
    scorers.
    """
    t0 = time.perf_counter()
    model, pos0, truth, nsrc = _sbc_setup(k, rng, nwalkers, nsteps, box,
                                          size_ln, device)
    setup_s = time.perf_counter() - t0
    chain, burn, tau, run_s = _sample(model, pos0, 3000 + k)
    post = chain[burn:]
    ranks = _thinned_ranks(post, tau, M, rng,
                           np.asarray([truth[nm] for nm in PARAMS]))
    layout = model.layout
    cover = _interval_coverage(post.reshape(-1, layout.ndim),
                               list(layout.names), truth)
    _log_split("sbc", k, nsrc, setup_s, run_s,
               model.lnprob_batch().engine)
    return ranks, cover, nsrc, tau


def _z_setup(k, rng, n_target, nwalkers, nsteps, pad, size_ln, device):
    """:func:`coverage_replicate_z`'s truth, model, starts and the
    amplitude-rescaled phistar."""
    truth = dict(Lstar=rng.uniform(42.2, 42.8),
                 phistar=rng.uniform(-3.2, -2.2),
                 sch_al=rng.uniform(-1.8, -1.2))
    cfg = LFConfig(min_comp_frac=0.5, fix_comp=True, quadrature="gauss",
                   nwalkers=nwalkers, nsteps=nsteps, seed=k,
                   size_ln=int(size_ln), **truth)
    cat = apply_completeness_cut(
        make_catalog(cfg, n_target=n_target, seed=2000 + k,
                     lum_err_dex=0.0), cfg)
    model = _model(LumFuncModelZ, cfg, cat, device, pad)
    return (model, _uniform_start(model, 2 * k), truth,
            cat["theta_true"]["phistar"], len(cat["z"]))


def coverage_replicate_z(k, rng, n_target=800, nwalkers=32, nsteps=800,
                         pad=1024, size_ln=41, device=None):
    """One frequentist-coverage replicate of the redshift-evolving
    (3-pivot) model: the catalog is drawn from a NON-evolving Schechter
    process, so every L* pivot's truth is the generating Lstar and every
    phi* pivot's the (amplitude-rescaled) phistar; the quadratic
    evolution model must recover flat evolution with nominal coverage.

    Returns ``({name: (in68, in95)}, names)``.
    """
    t0 = time.perf_counter()
    model, pos0, truth, phistar_eff, nsrc = _z_setup(
        k, rng, n_target, nwalkers, nsteps, pad, size_ln, device)
    setup_s = time.perf_counter() - t0
    chain, burn, _, run_s = _sample(model, pos0, 2 * k + 1)
    layout = model.layout
    post = chain[burn:].reshape(-1, layout.ndim)
    truths = dict(zip(layout.names,
                      [truth["Lstar"]] * 3 + [phistar_eff] * 3
                      + [truth["sch_al"]]))
    _log_split("z", k, nsrc, setup_s, run_s, model.lnprob_batch().engine)
    return (_interval_coverage(post, list(layout.names), truths),
            list(layout.names))


def _hier_setup(k, rng, nfields, nwalkers, nsteps, size_ln, device):
    """:func:`sbc_replicate_h`'s truth (the exact hier prior), one
    physical-normalization catalog per field, the joint model and its
    starts."""
    flim = _DEFAULT_FLIM[:nfields]
    omega = _DEFAULT_OMEGA_0[:nfields]
    cfg = LFConfig(min_comp_frac=0.5, fix_comp=True, quadrature="gauss",
                   nwalkers=nwalkers, nsteps=nsteps, seed=k,
                   Flim=flim, Omega_0=omega, size_ln=int(size_ln),
                   **HIER_BOX)
    layout = ThetaLayoutH.from_config(cfg)
    theta_true = _draw_hier_truth(rng, layout)
    kf = 4 + (0 if layout.fix_sch_al else 1)
    sch_al = layout.sch_al0 if layout.fix_sch_al else theta_true[4]
    # each field's catalog from its OWN (Lstar_f, phistar_f), physical
    # normalization: a rescale would shift the phistar_f the posterior
    # estimates off the drawn truth
    cats = []
    for f in range(nfields):
        cfg_f = LFConfig(min_comp_frac=0.5, fix_comp=True,
                         quadrature="gauss", seed=k,
                         Flim=(flim[f],), Omega_0=(omega[f],),
                         Lstar=float(theta_true[kf + f]),
                         phistar=float(theta_true[kf + nfields + f]),
                         sch_al=float(sch_al))
        cat_f = apply_completeness_cut(
            make_catalog(cfg_f, n_target=None, seed=1000 + 7 * k + f,
                         lum_err_dex=0.0), cfg_f)
        cat_f["field_id"] = np.full(len(cat_f["z"]), f, dtype=np.int32)
        cats.append(cat_f)
    cat = {c: np.concatenate([cf[c] for cf in cats])
           for c in ("z", "flux", "flux_e", "field_id")}
    model = _model(LumFuncModelH, cfg, cat, device)
    return model, _uniform_start(model, 2000 + k), theta_true, len(cat["z"])


def sbc_replicate_h(k, rng, nfields=2, nwalkers=48, nsteps=800, M=7,
                    size_ln=41, device=None):
    """One hierarchical-family SBC replicate: truth ~ the exact hier
    prior (:func:`_draw_hier_truth`), one physical-normalization catalog
    PER FIELD from that field's own (Lstar_f, phistar_f), joint fit, rank
    of the truth among ``M`` thinned posterior draws plus interval
    coverage (a valid frequentist check: the truth came from the fitting
    prior).

    Returns ``(ranks (ndim,), cover {name: (in68, in95)}, nsrc, tau)``.
    """
    t0 = time.perf_counter()
    model, pos0, theta_true, nsrc = _hier_setup(k, rng, nfields, nwalkers,
                                                nsteps, size_ln, device)
    setup_s = time.perf_counter() - t0
    chain, burn, tau, run_s = _sample(model, pos0, 3000 + k)
    post = chain[burn:]
    ranks = _thinned_ranks(post, tau, M, rng, theta_true)
    layout = model.layout
    cover = _interval_coverage(post.reshape(-1, layout.ndim),
                               list(layout.names),
                               dict(zip(layout.names, theta_true)))
    _log_split("hier", k, nsrc, setup_s, run_s,
               model.lnprob_batch().engine)
    return ranks, cover, nsrc, tau


def _map_start(res, z, u, lo, hi):
    """The Laplace start: ``theta + 2 z L^T`` (``L`` the Cholesky factor
    of the Laplace ``cov``, ``z`` (W, D) standard normal draws), each
    component outside the open box replaced by ``0.8 mid + 0.2 u`` (``u``
    the uniform box starts). None where the covariance is unusable: no
    negative definite Hessian, or a mode on a box edge, whose NaN rows
    Cholesky would silently propagate."""
    if not res["hess_ok"] or np.asarray(res["boundary"]).any():
        return None
    chol = torch.as_tensor(np.linalg.cholesky(res["cov"]), dtype=z.dtype,
                           device=z.device)
    pos = (torch.as_tensor(res["theta"], dtype=z.dtype,
                           device=z.device)[None, :]
           + 2.0 * (z @ chol.T))
    mid = (lo + hi) / 2.0
    return torch.where((pos > lo) & (pos < hi), pos,
                       0.8 * mid[None, :] + 0.2 * u)


def _coverage_setup(k, rng, free, pallas, init_map, n_target, nwalkers,
                    nsteps, pad, device):
    """:func:`coverage_replicate`'s truth, model and starts (uniform, or
    with ``init_map`` the Laplace start when it is usable)."""
    truth = dict(Lstar=rng.uniform(42.2, 42.8),
                 phistar=rng.uniform(-3.2, -2.2),
                 sch_al=rng.uniform(-1.8, -1.2))
    if nsteps is None:
        nsteps = 1500 if free else 600
    cfg = LFConfig(min_comp_frac=0.5, fix_comp=not free,
                   quadrature="gauss", nwalkers=nwalkers, nsteps=nsteps,
                   seed=k, use_pallas=pallas, **truth)
    cat = apply_completeness_cut(
        make_catalog(cfg, n_target=n_target, seed=1000 + k,
                     lum_err_dex=0.0), cfg)
    truth["phistar"] = cat["theta_true"]["phistar"]   # amplitude rescale
    if free:
        for i in range(len(cfg.Flim)):
            truth[f"Flim_{i}"] = cfg.Flim[i]
        truth["alpha"] = cfg.alpha
    model = _model(LumFuncModel, cfg, cat, device, pad)
    if not init_map:
        return model, _uniform_start(model, 2 * k), truth, len(cat["z"])
    from lumfuncmcmc_tpu_torch.models.mapfit import laplace_fit
    layout, dev = model.layout, model.device
    res = laplace_fit(model._make_scalar_lnprob(model.context64()),
                      *layout.bounds_arrays(torch.float64, dev),
                      generator=_generator(5 * k + 3, dev), nstarts=4)
    u = _uniform_start(model, 3 * k + 7)
    z = torch.randn((nwalkers, layout.ndim), generator=_generator(2 * k, dev),
                    dtype=model.dtype, device=dev)
    pos0 = _map_start(res, z, u, *layout.bounds_arrays(model.dtype, dev))
    setup_logging().info(
        "calibration replicate %d: %s" % (
            k, "Laplace start (2x the Laplace covariance around the MAP)"
            if pos0 is not None else
            "uniform starts (Laplace covariance unavailable: %s)"
            % ("MAP pinned at a prior bound" if res["hess_ok"]
               else "Hessian not negative definite")))
    return model, (u if pos0 is None else pos0), truth, len(cat["z"])


def coverage_replicate(k, rng, free=False, pallas=None, move="stretch",
                       init_map=False, n_target=1500, nwalkers=64,
                       nsteps=None, pad=2048, device=None):
    """One frequentist-coverage replicate: truth varied per replicate
    (narrower than the fitting box: the interval check, not SBC), fixed
    catalog size, full fit with the proposal ``move`` ("stretch", "de"
    or "mix") from uniform starts or, with ``init_map``, the Laplace
    start (:func:`_map_start`; the uniform starts where it is unusable).
    ``pallas``: None takes the model's engine (the value kernel on the
    card, float64 eager on the CPU), True the value kernel's route (its
    plain version on the CPU), False the eager engine. The source axis
    is padded to a multiple of ``pad``, as in the JAX package.

    Returns ``{name: (in68, in95)}`` per layout parameter.
    """
    t0 = time.perf_counter()
    model, pos0, truth, nsrc = _coverage_setup(
        k, rng, free, pallas, init_map, n_target, nwalkers, nsteps, pad,
        device)
    setup_s = time.perf_counter() - t0
    chain, burn, _, run_s = _sample(model, pos0, 2 * k + 1, move)
    layout = model.layout
    post = chain[burn:].reshape(-1, layout.ndim)
    _log_split("coverage", k, nsrc, setup_s, run_s,
               model.lnprob_batch().engine)
    return _interval_coverage(post, list(layout.names), truth)
