"""Shared cases of the PyTorch port's model-comparison tests.

One small synthetic catalog per model family (``free``: free
completeness; ``fixed``; ``z``; ``hier``), its float64 JAX context, the
port's context on the same arrays (``context_from_arrays``), both
packages' layouts, and posterior draws from a short stretch run of the
port's eager engine, so both packages are handed the same samples.
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch

from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.models.context import build_context as jax_build
from lumfuncmcmc_tpu.models.hierarchical import ThetaLayoutH as JaxH
from lumfuncmcmc_tpu.models.likelihood import ThetaLayout as JaxL
from lumfuncmcmc_tpu.models.likelihood_z import ThetaLayoutZ as JaxZ
from lumfuncmcmc_tpu.utils.synth import apply_completeness_cut, make_catalog
from lumfuncmcmc_tpu_torch import LFConfig as PortConfig
from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
from lumfuncmcmc_tpu_torch.models.context import (
    CTX_FIELDS, context_from_arrays)
from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH, make_lnprob_h
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, make_lnprob, sample_init)
from lumfuncmcmc_tpu_torch.models.likelihood_z import ThetaLayoutZ, make_lnprob_z
from lumfuncmcmc_tpu_torch.samplers.affine import run_stretch

FAMILIES = ("free", "fixed", "z", "hier")


def _arrays(jctx):
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    return arrays


@functools.lru_cache(maxsize=None)
def case(fam, size_ln=21, n=500, seed=5):
    """The catalog, contexts and layouts of family ``fam``."""
    kw = dict(min_comp_frac=0.5, size_ln=size_ln, fix_comp=fam != "free")
    jcfg, pcfg = LFConfig(**kw), PortConfig(**kw)
    cat = apply_completeness_cut(make_catalog(jcfg, n_target=n, seed=seed),
                                 jcfg)
    _, jctx = jax_build(jcfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        dtype=jnp.float64)
    pctx = context_from_arrays(_arrays(jctx), "cpu", torch.float64)
    jlay = {"z": JaxZ, "hier": JaxH}.get(fam, JaxL).from_config(jcfg)
    play = {"z": ThetaLayoutZ, "hier": ThetaLayoutH}.get(
        fam, ThetaLayout).from_config(pcfg)
    return SimpleNamespace(fam=fam, jcfg=jcfg, pcfg=pcfg, cat=cat,
                           jctx=jctx, pctx=pctx, jlay=jlay, play=play)


@functools.lru_cache(maxsize=None)
def posterior(fam, nsteps=300, nwalkers=32, seed=0):
    """Flat post-burn draws (S, D+1) of a port stretch run (eager
    engine, float64), the last column its lnprob: ``fit_model``'s
    ``samples`` layout."""
    c = case(fam)
    make = {"z": make_lnprob_z, "hier": make_lnprob_h}.get(fam, make_lnprob)
    lnprob = make(c.pctx, c.play)
    gen = torch.Generator().manual_seed(seed)
    pos0 = sample_init(gen, c.play, nwalkers)
    _, chain, lnps, _ = run_stretch(lnprob, pos0, gen, nsteps)
    full = torch.cat([chain, lnps[:, :, None]], dim=2)[nsteps // 2:]
    return full.reshape(-1, c.play.ndim + 1).numpy()


def central(layout, w, seed, keep=0.3):
    """Prior draws shrunk toward the box centre (thetas a chain meets)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(layout.lo), np.asarray(layout.hi)
    th = lo + rng.uniform(size=(w, layout.ndim)) * (hi - lo)
    return (1 - keep) * 0.5 * (lo + hi)[None, :] + keep * th
