"""PyTorch port vs JAX package: the 1/V_eff cross-check.

Weights, bin edges and binned LF agree to float64 rounding; the
bootstrap variance agrees when both sides resample with the same
indices (the port's ``_binned_lf_bootstrap_idx`` is fed the indices
JAX draws from its key)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.models import veff as jveff
from lumfuncmcmc_tpu.models.model import LumFuncModel as JaxModel
from lumfuncmcmc_tpu.ops.completeness import fleming_root_logf_np
from lumfuncmcmc_tpu_torch.models import veff as tveff
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

torch.set_num_threads(2)


def _models(mcf=0.5):
    cfg = LFConfig(min_comp_frac=mcf, size_ln=11, nboot=40, nbins=12)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=400, seed=4),
                                 cfg)
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"])
    return (cfg, JaxModel(cfg, **kw),
            LumFuncModel(cfg, device="cpu", dtype=torch.float64, **kw))


def test_veff_weights_and_edges_match_jax():
    for mcf in (0.5, 0.0):
        cfg, jm, tm = _models(mcf)
        logF50 = np.log10(np.asarray(cfg.Flim)) - 17.0
        roots = (fleming_root_logf_np(logF50, cfg.alpha, mcf, cfg.fcmin)
                 if mcf else np.full(len(logF50), -np.inf))
        fid = np.asarray(jm.ctx.field_id)
        want = jveff.veff_weights(
            jm.ctx.logf_src, jm.ctx.lum, jnp.asarray(logF50)[fid],
            jnp.asarray(roots)[fid], float(np.sum(cfg.Omega_0)), jm.zmin,
            jm.zmax, cfg.alpha, jm.ctx.cosmo, cfg.fcmin, mcf)
        got = tveff.veff_weights(
            tm.ctx.logf_src, tm.ctx.lum, torch.tensor(logF50)[fid],
            torch.tensor(roots)[fid], float(np.sum(cfg.Omega_0)),
            tm.zmin, tm.zmax, torch.tensor(cfg.alpha, dtype=torch.float64),
            tm.ctx.cosmo, cfg.fcmin, mcf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-11)
        np.testing.assert_allclose(
            tveff.log_bin_edges(tm.ctx.lum, cfg.nbins).numpy(),
            np.asarray(jveff.log_bin_edges(jm.ctx.lum, cfg.nbins)),
            rtol=1e-13)


def test_bootstrap_matches_jax_on_the_same_indices():
    cfg, jm, tm = _models()
    rng = np.random.default_rng(1)
    lum = np.asarray(jm.ctx.lum)
    phi = rng.uniform(0.5, 2.0, lum.shape) * 1e-4
    edges = np.asarray(jveff.log_bin_edges(jnp.asarray(lum), cfg.nbins))
    key = jax.random.PRNGKey(3)
    lavg, lf, var = jveff.binned_lf_bootstrap(
        key, jnp.asarray(lum), jnp.asarray(phi), jnp.asarray(edges),
        cfg.nboot, cfg.nbins)
    # the indices binned_lf_bootstrap draws from its key
    idx = np.stack([np.asarray(jax.random.randint(k, (len(lum),), 0,
                                                  len(lum)))
                    for k in jax.random.split(key, cfg.nboot)])
    got = tveff._binned_lf_bootstrap_idx(
        torch.as_tensor(lum), torch.as_tensor(phi), torch.as_tensor(edges),
        torch.as_tensor(idx, dtype=torch.int64), cfg.nbins)
    for g, w in zip(got, (lavg, lf, var)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)


def test_model_veff_lf_matches_jax_model():
    """The model-level 1/V_eff: bin centres and binned LF are exact; the
    variance comes from another generator, so only its scale agrees."""
    _, jm, tm = _models()
    jl, jlf, jvar = jm.veff_lf()
    tl, tlf, tvar = tm.veff_lf()
    np.testing.assert_allclose(tl, jl, rtol=1e-12)
    np.testing.assert_allclose(tlf, jlf, rtol=1e-10)
    assert (tvar > 0).all()
    ok = jvar > 0
    ratio = np.median(tvar[ok] / jvar[ok])
    assert 0.5 < ratio < 2.0
