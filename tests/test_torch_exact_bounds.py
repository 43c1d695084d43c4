"""PyTorch port vs JAX package: the exact-bounds likelihood.

- ``fleming_root_logf``: value at 1e-12 (float64) and its implicit-function
  gradient against JAX's custom JVP at 1e-9 and finite differences;
- ``lnlike_exact_bounds_parts`` / ``lnlike_exact_bounds`` at
  ``min_comp_frac`` 0.5 (two z panels split at the kink) and 0 (one
  panel), relative 1e-9 (the bar of ``tests/test_likelihood*.py``), and
  its gradient at 1e-8, on the same context carried from JAX;
- at the build theta the exact bounds agree with the frozen-bound gauss
  likelihood at the tolerance of JAX's own test
  (``tests/test_likelihood.py::test_exact_bounds_matches_frozen_at_build_theta``);
- the exact-bounds pointwise IC against JAX's ``make_pointwise_fns``;
- the engine rule: no kernel computes exact bounds, so auto mode takes
  the eager engine (ensemble and NUTS) and an explicit ``use_pallas``
  raises; ``fit --exact-bounds`` runs through the CLI.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.models import ic as jic
from lumfuncmcmc_tpu.models import likelihood as jlik
from lumfuncmcmc_tpu.models.context import build_context as jax_build
from lumfuncmcmc_tpu.ops import completeness as jcomp
from lumfuncmcmc_tpu.utils.synth import apply_completeness_cut, make_catalog
from lumfuncmcmc_tpu_torch import LFConfig as PortConfig
from lumfuncmcmc_tpu_torch.cli.main import main as port_main
from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
from lumfuncmcmc_tpu_torch.models import ic as tic
from lumfuncmcmc_tpu_torch.models import likelihood as tlik
from lumfuncmcmc_tpu_torch.models.context import (
    CTX_FIELDS, context_from_arrays)
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
from lumfuncmcmc_tpu_torch.ops import completeness as tcomp

torch.set_num_threads(2)


def test_fleming_root_value_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    f50 = -16.9 + 0.4 * rng.normal(size=6)
    alpha = 2.5 + 2.0 * rng.uniform(size=6)
    for mcf, fcmin in ((0.5, 0.1), (0.8, 0.0), (0.2, 0.3)):
        want = np.asarray(jcomp.fleming_root_logf(
            jnp.asarray(f50), jnp.asarray(alpha), mcf, fcmin))
        tf = torch.tensor(f50, requires_grad=True)
        ta = torch.tensor(alpha, requires_grad=True)
        got = tcomp.fleming_root_logf(tf, ta, mcf, fcmin)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12)
        gf, ga = torch.autograd.grad(got.sum(), (tf, ta))
        jg = jax.vmap(jax.grad(lambda f, a: jcomp.fleming_root_logf(
            f, a, mcf, fcmin), argnums=(0, 1)))(jnp.asarray(f50),
                                                  jnp.asarray(alpha))
        np.testing.assert_allclose(gf.numpy(), np.asarray(jg[0]), rtol=1e-9)
        np.testing.assert_allclose(ga.numpy(), np.asarray(jg[1]), rtol=1e-9)
        h = 1e-6
        for g, x, bump in ((gf, f50, (h, 0.0)), (ga, alpha, (0.0, h))):
            up = tcomp.fleming_root_logf(torch.tensor(f50 + bump[0]),
                                         torch.tensor(alpha + bump[1]),
                                         mcf, fcmin)
            dn = tcomp.fleming_root_logf(torch.tensor(f50 - bump[0]),
                                         torch.tensor(alpha - bump[1]),
                                         mcf, fcmin)
            np.testing.assert_allclose(g.numpy(), ((up - dn) / 2e-6).numpy(),
                                       rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _setup(mcf, quadrature="trapz", size_ln=19):
    cfg = LFConfig(min_comp_frac=mcf, size_ln=size_ln, quadrature=quadrature)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=250, seed=11),
                                 cfg)
    _, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    return (cfg, jctx, jlik.ThetaLayout.from_config(cfg), ctx,
            tlik.ThetaLayout.from_config(cfg),
            float(np.min(np.asarray(jctx.lum))))


def _thetas(cfg, layout, n=6, seed=1):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(layout.lo), np.asarray(layout.hi)
    center = np.array([42.5, -3.0, -1.5, *cfg.Flim, cfg.alpha])
    return center + 0.02 * (hi - lo) * rng.normal(size=(n, layout.ndim))


@pytest.mark.parametrize("mcf", [0.5, 0.0])
def test_exact_bounds_likelihood_and_gradient_match_jax(mcf):
    cfg, jctx, jl, ctx, tl, floor = _setup(mcf)
    th = _thetas(cfg, jl)
    want = np.asarray(jax.jit(jax.vmap(lambda t: jnp.stack(
        jlik.lnlike_exact_bounds_parts(t, jctx, jl, mcf, floor, cfg.Lh))))(
            jnp.asarray(th)))
    got = torch.stack(tlik.lnlike_exact_bounds_parts(
        torch.as_tensor(th), ctx, tl, mcf, floor, cfg.Lh), 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    jg = np.asarray(jax.jit(jax.vmap(jax.grad(lambda t: (
        jlik.lnlike_exact_bounds(t, jctx, jl, mcf, floor, cfg.Lh)))))(
            jnp.asarray(th)))
    tt = torch.as_tensor(th).requires_grad_()
    (tg,) = torch.autograd.grad(
        tlik.lnlike_exact_bounds(tt, ctx, tl, mcf, floor, cfg.Lh).sum(), tt)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-8,
                               atol=1e-8 * np.abs(jg).max())
    # the prior-masked lnprob matches JAX's, out-of-box rows included
    th[0, 0] = jl.hi[0] + 1.0
    jfn = jax.jit(jax.vmap(jlik.make_lnprob(jctx, jl, exact_bounds=True,
                                            min_comp_frac=mcf,
                                            lh=cfg.Lh)))
    tfn = tlik.make_lnprob(ctx, tl, exact_bounds=True, min_comp_frac=mcf,
                           lh=cfg.Lh)
    w = np.asarray(jfn(jnp.asarray(th)))
    g = tfn(torch.as_tensor(th)).numpy()
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    np.testing.assert_allclose(g[1:], w[1:], rtol=1e-9)


def test_exact_bounds_match_the_frozen_bounds_at_the_build_theta():
    cfg, _, _, ctx, tl, floor = _setup(0.5, "gauss", 48)
    th = torch.tensor([[42.6, -2.8, -1.5, *cfg.Flim, cfg.alpha]],
                      dtype=torch.float64)
    frozen = float(tlik.lnlike_single_epoch(th, ctx, tl)[0])
    exact = float(tlik.lnlike_exact_bounds(th, ctx, tl, 0.5, floor, cfg.Lh,
                                           n_nodes=48)[0])
    np.testing.assert_allclose(exact, frozen, atol=1e-5, rtol=0)


def test_exact_bounds_pointwise_ic_matches_jax():
    cfg, jctx, jl, ctx, tl, _ = _setup(0.5)
    th = _thetas(cfg, jl, n=4, seed=3)
    jll, jparts = jic.make_pointwise_fns(jctx, jl, exact_bounds=True,
                                         min_comp_frac=0.5, lh=cfg.Lh)
    tll, tparts = tic.make_pointwise_fns(ctx, tl, exact_bounds=True,
                                         min_comp_frac=0.5, lh=cfg.Lh)
    mask = np.asarray(jctx.src_mask) > 0
    cols = [np.asarray(getattr(jctx, k))[mask] for k in
            ("lum", "zsrc", "ln_om_src", "logf_src", "omega0_src",
             "field_id")]
    want = np.stack([np.asarray(jll(jnp.asarray(t), *map(jnp.asarray, cols)))
                     for t in th])
    got = tll(torch.as_tensor(th), *map(torch.as_tensor, cols)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    want_parts = np.asarray([np.asarray(jparts(jnp.asarray(t))) for t in th])
    got_parts = torch.stack(tparts(torch.as_tensor(th)), 1).numpy()
    np.testing.assert_allclose(got_parts, want_parts, rtol=1e-9)
    with pytest.raises(ValueError, match="free completeness"):
        tic.make_pointwise_fns(ctx, tlik.ThetaLayout.from_config(
            PortConfig(fix_comp=True)), exact_bounds=True)


def _model(**kw):
    cat = apply_completeness_cut(make_catalog(LFConfig(min_comp_frac=0.5),
                                              n_target=150, seed=5),
                                 LFConfig(min_comp_frac=0.5))
    cfg = PortConfig(min_comp_frac=0.5, size_ln=7, nwalkers=8, nsteps=6,
                     exact_bounds=True).replace(**kw)
    return LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        device="cpu", dtype=torch.float64)


def test_engine_rule_and_cli_run(tmp_path, monkeypatch):
    model = _model()
    assert model.exact_bounds and not model._resolve_use_pallas()
    assert model.lnprob_batch().engine == "eager"
    th = torch.tensor([[42.6, -2.8, -1.5, *model.cfg.Flim, model.cfg.alpha]],
                      dtype=torch.float64)
    lnp = model.lnprob_batch()(th)
    assert torch.isfinite(lnp).all()
    # the evidence ladder's data term and the NUTS gradient path take the
    # same exact-bounds likelihood (no kernel)
    want = tlik.lnlike_exact_bounds(th, model.ctx, model.layout, 0.5,
                                    float(model.ctx.lum.min()), model.cfg.Lh)
    assert torch.equal(model._prior_like_fns()[1](th), want)
    assert torch.equal(model._nuts_gradient_post()(th), lnp)
    with pytest.raises(ValueError, match="exact_bounds is not implemented"):
        _model(use_pallas=True).lnprob_batch()
    # fixed completeness has no bounds to re-derive: the flag is inert
    assert not _model(fix_comp=True).exact_bounds
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"output_dict": {"parameters": true, "settings": true,'
                   ' "fitposterior": true, "bestfitLF": true, "VeffLF": '
                   'true, "triangle plot": false, "image format": "png"}}')
    assert port_main(["fit", "--exact-bounds", "--synthetic", "150", "-mcf",
                      "0.5", "-ns", "6", "-nw", "8", "--size-ln", "7",
                      "--device", "cpu", "-o", "e.dat", "--ic",
                      "--config", str(cfg)]) == 0
    out = tmp_path / "LFMCMCOut"
    for kind in ("fitposterior", "bestfitLF", "VeffLF", "ic"):
        assert (out / f"{kind}_e_nb50_nw8_ns6_mcf50.dat").exists(), kind
