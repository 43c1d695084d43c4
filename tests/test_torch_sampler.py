"""PyTorch port vs JAX package: the ensemble sampler and diagnostics.

The two frameworks draw different random numbers from one seed, so the
steps are compared on identical numpy randoms: stretch, DE and mix
steps against JAX's ``_step_pre`` / ``_step_de_pre`` for 20 steps, float64,
chains equal to 1e-10 (the only difference is rounding in the lnprob).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.samplers import affine as jaff
from lumfuncmcmc_tpu_torch.samplers import affine as taff
from lumfuncmcmc_tpu_torch.samplers import diagnostics as tdiag

# lumfuncmcmc_tpu.samplers may re-export names over its submodules
jdiag = importlib.import_module("lumfuncmcmc_tpu.samplers.diagnostics")

torch.set_num_threads(2)
NSTEPS, NW, NDIM = 20, 16, 4
_RNG = np.random.default_rng(0)
_A = _RNG.normal(size=(NDIM, NDIM))
PREC = _A @ _A.T / NDIM + np.eye(NDIM)        # correlated Gaussian target
MU = np.array([1.0, -2.0, 0.5, 3.0])


def _lnp_jax(x):
    d = x - MU
    lnp = -0.5 * jnp.einsum("wi,ij,wj->w", d, PREC, d)
    return jnp.where(jnp.all(jnp.abs(d) < 8.0, axis=1), lnp, -jnp.inf)


def _lnp_torch(x):
    d = x - torch.as_tensor(MU)
    lnp = -0.5 * torch.einsum("wi,ij,wj->w", d, torch.as_tensor(PREC), d)
    return torch.where(torch.all(d.abs() < 8.0, dim=1), lnp,
                       torch.full_like(lnp, -np.inf))


def _stretch_rands(rng, n=NSTEPS, nh=NW // 2):
    return (rng.uniform(size=(n, 2, nh)), rng.integers(0, nh, (n, 2, nh)),
            np.log(rng.uniform(size=(n, 2, nh))))


def _de_rands(rng, n=NSTEPS, nh=NW // 2):
    g = 2.38 / np.sqrt(2 * NDIM) * (1 + 1e-5 * rng.normal(size=(n, 2, nh)))
    g = np.where(rng.uniform(size=(n, 2, nh)) < 0.1, 1.0, g)
    j1 = rng.integers(0, nh, (n, 2, nh))
    j2 = rng.integers(0, nh - 1, (n, 2, nh))
    j2 = j2 + (j2 >= j1)
    return g, j1, j2, np.log(rng.uniform(size=(n, 2, nh)))


def _jax_chain(pos0, move, sr, dr, sel, lnp_batch=_lnp_jax):
    state = jaff.EnsembleState(jnp.asarray(pos0),
                               lnp_batch(jnp.asarray(pos0)))
    chain, acc = [], 0.0
    for t in range(NSTEPS):
        if move == "stretch" or (move == "mix" and not sel[t]):
            r = tuple(jnp.asarray(x[t]) for x in sr)
            state, a = jaff._step_pre(r, state, lnp_batch, 2.0)
        else:
            r = tuple(jnp.asarray(x[t]) for x in dr)
            state, a = jaff._step_de_pre(r, state, lnp_batch)
        acc = acc + np.asarray(a)
        chain.append(np.asarray(state.pos))
    return np.stack(chain), acc


def _t(rands):
    return tuple(torch.as_tensor(x) for x in rands)


@pytest.mark.parametrize("move", ["stretch", "de", "mix"])
def test_steps_match_jax_on_identical_randoms(move):
    rng = np.random.default_rng(3)
    pos0 = MU + rng.normal(size=(NW, NDIM))
    sr, dr = _stretch_rands(rng), _de_rands(rng)
    sel = jaff.de_schedule(NSTEPS, 0.4)
    np.testing.assert_array_equal(taff.de_schedule(NSTEPS, 0.4), sel)
    want, want_acc = _jax_chain(pos0, move, sr, dr, sel)
    rands = {"stretch": _t(sr), "de": _t(dr),
             "mix": (sel, _t(sr), _t(dr))}[move]
    _, chain, lnps, acc = taff.run_with_rands(
        _lnp_torch, torch.as_tensor(pos0), rands, NSTEPS, move=move)
    np.testing.assert_allclose(chain.numpy(), want, rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    assert 0 < want_acc.sum() < NSTEPS * NW
    np.testing.assert_allclose(lnps.numpy(),
                               np.asarray(_lnp_jax(jnp.asarray(
                                   want.reshape(-1, NDIM)))).reshape(
                                   NSTEPS, NW), rtol=1e-10)


def test_thinning_records_every_thin_th_state():
    rng = np.random.default_rng(4)
    pos0 = MU + rng.normal(size=(NW, NDIM))
    sr = _stretch_rands(rng)
    want, _ = _jax_chain(pos0, "stretch", sr, None, None)
    _, chain, _, _ = taff.run_with_rands(
        _lnp_torch, torch.as_tensor(pos0), _t(sr), NSTEPS, thin=4)
    np.testing.assert_allclose(chain.numpy(), want[3::4], rtol=1e-10,
                               atol=1e-10)


def test_real_likelihood_steps_match_jax():
    """The slice's own lnprob under identical randoms, 8 stretch steps."""
    from lumfuncmcmc_tpu.config import LFConfig
    from lumfuncmcmc_tpu.models import likelihood as jlik
    from lumfuncmcmc_tpu.models.context import build_context as jax_build
    from lumfuncmcmc_tpu.utils.synth import (
        apply_completeness_cut, make_catalog)
    from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
    from lumfuncmcmc_tpu_torch.models import likelihood as tlik
    from lumfuncmcmc_tpu_torch.models.context import (
        CTX_FIELDS, context_from_arrays)

    cfg = LFConfig(min_comp_frac=0.5, size_ln=13)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=150, seed=2),
                                 cfg)
    _, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                        field_id=cat["field_id"], dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    jl = jlik.ThetaLayout.from_config(cfg)
    jfn = jax.jit(jax.vmap(jlik.make_lnprob(jctx, jl)))
    tfn = tlik.make_lnprob(ctx, tlik.ThetaLayout.from_config(cfg))
    rng = np.random.default_rng(5)
    lo, hi = np.asarray(jl.lo), np.asarray(jl.hi)
    center = np.array([42.5, -3.0, -1.5, *cfg.Flim, cfg.alpha])
    pos0 = center + 0.02 * (hi - lo) * rng.normal(size=(NW, jl.ndim))
    n = 8
    sr = _stretch_rands(rng, n=n)
    state = jaff.EnsembleState(jnp.asarray(pos0), jfn(jnp.asarray(pos0)))
    for t in range(n):
        state, _ = jaff._step_pre(tuple(jnp.asarray(x[t]) for x in sr),
                                  state, jfn, 2.0)
    st, _, _, acc = taff.run_with_rands(tfn, torch.as_tensor(pos0), _t(sr),
                                        n)
    assert acc.sum() > 0
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(state.pos),
                               rtol=1e-10)
    np.testing.assert_allclose(st.lnp.numpy(), np.asarray(state.lnp),
                               rtol=1e-10)


def test_run_stretch_draws_from_the_generator_and_validates():
    pos0 = torch.as_tensor(MU + np.random.default_rng(6).normal(
        size=(NW, NDIM)))
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(9)
        runs.append(taff.run_stretch(_lnp_torch, pos0, gen, 30, move="mix",
                                     de_prob=0.7, thin=3))
    for a, b in zip(runs[0][1:], runs[1][1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, chain, lnps, acc = runs[0]
    assert chain.shape == (10, NW, NDIM) and lnps.shape == (10, NW)
    assert 0 < acc.sum() < 30 * NW
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="even"):
        taff.run_stretch(_lnp_torch, pos0[:5], gen, 4)
    with pytest.raises(ValueError, match="multiple of thin"):
        taff.run_stretch(_lnp_torch, pos0, gen, 10, thin=3)
    with pytest.raises(ValueError, match="nwalkers >= 4"):
        taff.run_stretch(_lnp_torch, pos0[:2], gen, 4, move="de")
    with pytest.raises(ValueError, match="unknown move"):
        taff.run_stretch(_lnp_torch, pos0, gen, 4, move="walk")


def test_bulk_rand_shapes_and_distinct_de_partners():
    gen = torch.Generator().manual_seed(1)
    u_z, j, ln_u = taff._stretch_rands(gen, 7, 5, torch.float64, "cpu")
    assert u_z.shape == j.shape == ln_u.shape == (7, 2, 5)
    assert (ln_u <= 0).all() and (j >= 0).all() and (j < 5).all()
    g, j1, j2, _ = taff._de_rands(gen, 200, 5, NDIM, torch.float64, "cpu")
    assert (j1 != j2).all() and (j2 < 5).all()
    frac_jump = float((g == 1.0).double().mean())
    assert 0.05 < frac_jump < 0.15


def test_diagnostics_match_jax_package():
    rng = np.random.default_rng(8)
    x = np.cumsum(rng.normal(size=(300, 12, 3)), axis=0) * 0.1 \
        + rng.normal(size=(300, 12, 3))
    x[150:, :, 0] = x[150:, :, 0].round(1)       # ties for the ranks
    for name in ("integrated_autocorr_time", "effective_sample_size",
                 "gelman_rubin", "rank_normalized_rhat"):
        np.testing.assert_allclose(getattr(tdiag, name)(x),
                                   getattr(jdiag, name)(x), rtol=1e-10,
                                   err_msg=name)
    np.testing.assert_allclose(tdiag.mcse_quantile(x, 0.5),
                               jdiag.mcse_quantile(x, 0.5), rtol=1e-10)
    assert tdiag.burnin_steps(x, 300) == jdiag.burnin_steps(x, 300)
    p = np.linspace(0.001, 0.999, 101)
    np.testing.assert_allclose(tdiag._norm_ppf(p), jdiag._norm_ppf(p),
                               rtol=1e-12)
