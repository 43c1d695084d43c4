"""PyTorch port vs JAX package: the public library functions outside the
likelihood engines, float64 on the CPU, on inputs made from numpy seeds.

- ``fleming``, ``inverse_fleming``, ``p_curve``, ``efunc``, ``omega`` and
  ``lum_at_flux``: rtol 1e-12 (the same formulas; only libm rounding
  differs);
- ``min_flux_p_curve``, ``trapz_weights``, ``gauss_legendre`` and the
  fields of ``build_cosmo_table``: bit for bit (host float64 numpy on
  both sides);
- ``affine.step``: bit for bit against the port's ``run_stretch(nsteps=1)``
  from an identically seeded generator, and, fed the randoms JAX's
  ``step`` draws from its key, the port's ``_step_pre`` against JAX's
  ``step`` at rtol 1e-12 on a small catalog of the flagship ``fit``'s
  shape (free completeness, ``-mcf 0.5``);
- ``VeffLF()`` is ``veff_lf()``, and the ``lumfuncmcmc-tpu-torch``
  console script resolves to the port's CLI.
"""

import functools
import importlib
import pathlib
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu import cosmology as jcos
from lumfuncmcmc_tpu.ops import completeness as jcomp
from lumfuncmcmc_tpu.ops import quadrature as jquad
from lumfuncmcmc_tpu.samplers import affine as jaff
from lumfuncmcmc_tpu_torch import cosmology as tcos
from lumfuncmcmc_tpu_torch import ops as tops
from lumfuncmcmc_tpu_torch import samplers as tsamplers
from lumfuncmcmc_tpu_torch.ops import quadrature as tquad
from lumfuncmcmc_tpu_torch.ops.completeness import min_flux_p_curve
from lumfuncmcmc_tpu_torch.samplers import affine as taff

# each ops package re-exports its omega function over the module's name
jomega = importlib.import_module("lumfuncmcmc_tpu.ops.omega")
tomega = importlib.import_module("lumfuncmcmc_tpu_torch.ops.omega")
torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-12
FLEMING_CASES = [(3.0e-17, 3.5, 0.1), (2.72e-17, 4.56, 0.1),
                 (5.0e-17, 2.0, 0.3), (1.0e-17, 6.5, 0.05),
                 (3.0e-17, 3.5, 0), (3.0e-17, None, 0.1)]


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=0)


def _close_fraction(got, want):
    """A completeness fraction: rtol 1e-12 from 1e-30 up. Below it the
    faint-end modification fc ** (1 / (1 - exp(-f/f_tau))) raises fc to
    a power in the hundreds, so the one ulp by which the two libms may
    round exp there moves the value by up to ~1e-11 relative: those
    values are held by their logarithm (the exponent) at rtol 1e-12.
    XLA's CPU code flushes subnormals to 0, so where JAX gives 0 the
    port may give 0 or a subnormal."""
    got, want = got.numpy(), np.asarray(want)
    big = want >= 1e-30
    _close(got[big], want[big])
    tail = ~big & (want > 0)
    _close(np.log(got[tail]), np.log(want[tail]))
    assert np.all(got[want == 0] < np.finfo(np.float64).tiny)


@pytest.mark.parametrize("Flim, alpha, fcmin", FLEMING_CASES)
def test_fleming_matches_jax(Flim, alpha, fcmin):
    f = 10.0 ** np.random.default_rng(1).uniform(-19, -14, size=512)
    got = tops.fleming(_t(f), Flim, alpha, fcmin)
    assert got.dtype == torch.float64 and got.shape == f.shape
    want = jcomp.fleming(jnp.asarray(f), Flim, alpha, fcmin)
    _close_fraction(got, want)
    if alpha is not None:
        # Flim as a tensor too, and a float32 input stays float32
        _close_fraction(tops.fleming(_t(f), _t(Flim), alpha, fcmin), want)
        assert tops.fleming(_t(f).float(), Flim, alpha,
                            fcmin).dtype == torch.float32


def test_inverse_fleming_and_p_curve_match_jax():
    for f50, alpha, fcmin in [(3e-17, 3.5, 0.1), (2.7e-17, 4.56, 0.2),
                              (3e-17, 3.5, 0.7)]:
        got = tops.inverse_fleming(f50, alpha, fcmin)
        assert isinstance(got, float)
        _close(got, jcomp.inverse_fleming(f50, alpha, fcmin))
    rng = np.random.default_rng(2)
    f50 = 10.0 ** rng.uniform(-17.5, -16.5, size=32)
    alpha = rng.uniform(2.0, 6.0, size=32)
    _close(tops.inverse_fleming(_t(f50), _t(alpha), 0.1),
           jcomp.inverse_fleming(jnp.asarray(f50), jnp.asarray(alpha), 0.1))
    F = 10.0 ** rng.uniform(-18, -15, size=64)
    for Flim, alpha in [(3e-17, -3.5), (2e-17, -2.0), (3e-17, 3.5)]:
        _close(tops.p_curve(_t(F), Flim, alpha),
               jcomp.p_curve(jnp.asarray(F), Flim, alpha))


def test_host_rules_equal_jax_bit_for_bit():
    for mcf, Flim, alpha in [(0.5, 3e-17, -3.5), (0.2, 2.7e-17, -4.56),
                             (0.8, 5e-17, -2.0), (0.3, 3e-17, 3.5),
                             (0.0, 3e-17, -3.5), (1e-7, 3e-17, -3.5)]:
        assert (min_flux_p_curve(mcf, Flim, alpha)
                == jcomp.min_flux_p_curve(mcf, Flim, alpha))
    for n in (2, 11, 101):
        np.testing.assert_array_equal(
            tquad.trapz_weights(n, device="cpu").numpy(),
            np.asarray(jquad.trapz_weights(n)))
    assert tquad.trapz_weights(5, dtype=torch.float32,
                               device="cpu").dtype == torch.float32
    for n, a, b in [(32, 0.0, 1.0), (64, 0.05, 3.0), (7, -2.0, 5.5)]:
        for got, want in zip(tquad.gauss_legendre(n, a, b, device="cpu"),
                             jquad.gauss_legendre(n, a, b)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="device"):
        tquad.trapz_weights(5)


@functools.lru_cache(maxsize=None)
def _tables():
    return (jcos.build_cosmo_table(3.0, dtype=jnp.float64),
            tcos.build_cosmo_table(3.0, dtype=torch.float64, device="cpu"))


def test_cosmology_table_and_efunc_match_jax():
    jt, tt = _tables()
    for k in tcos.COSMO_FIELDS:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)))
    f32 = tcos.build_cosmo_table(3.0, n=1025, device="cpu")
    assert f32.zgrid.dtype == torch.float32 and f32.zgrid.shape == (1025,)
    with pytest.raises(TypeError, match="device"):
        tcos.build_cosmo_table(3.0)
    z = np.random.default_rng(3).uniform(0.0, 3.0, size=256)
    _close(tcos.efunc(_t(z)), jcos.efunc(jnp.asarray(z)))


def test_omega_and_lum_at_flux_match_jax():
    jt, tt = _tables()
    rng = np.random.default_rng(4)
    z = rng.uniform(1.9, 2.4, size=300)
    logL = rng.uniform(41.5, 43.5, size=300)
    for omega_0, logF50, alpha, fcmin in [(1.0e5, -16.5, 3.5, 0.1),
                                          (2.0e4, -16.6, 4.56, 0.0)]:
        _close(tops.omega(_t(logL), _t(z), tt, omega_0, logF50, alpha,
                          fcmin),
               jomega.omega(jnp.asarray(logL), jnp.asarray(z), jt, omega_0,
                            logF50, alpha, fcmin))
    F = 10.0 ** rng.uniform(-17.5, -15.5, size=300)
    _close(tomega.lum_at_flux(_t(F), _t(z), tt),
           jomega.lum_at_flux(jnp.asarray(F), jnp.asarray(z), jt))


@functools.lru_cache(maxsize=None)
def _flagship(nw=16):
    """A small catalog of the flagship ``fit``'s shape, the JAX context
    carried into the port so both sides sum the same grids; the two
    lnprobs and a start near the truth."""
    from lumfuncmcmc_tpu.config import LFConfig
    from lumfuncmcmc_tpu.models import likelihood as jlik
    from lumfuncmcmc_tpu.models.context import build_context as jax_build
    from lumfuncmcmc_tpu.utils.synth import (
        apply_completeness_cut, make_catalog)
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
                       for k in tcos.COSMO_FIELDS}
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    jl = jlik.ThetaLayout.from_config(cfg)
    jfn = jax.jit(jax.vmap(jlik.make_lnprob(jctx, jl)))
    tfn = tlik.make_lnprob(ctx, tlik.ThetaLayout.from_config(cfg))
    lo, hi = np.asarray(jl.lo), np.asarray(jl.hi)
    center = np.array([42.5, -3.0, -1.5, *cfg.Flim, cfg.alpha])
    pos0 = center + 0.02 * (hi - lo) * np.random.default_rng(5).normal(
        size=(nw, jl.ndim))
    return jfn, tfn, pos0


def test_step_equals_the_first_step_of_run_stretch():
    _, tfn, pos0 = _flagship()
    pos0 = torch.as_tensor(pos0)
    state = taff.EnsembleState(pos0, tfn(pos0))
    for seed in (0, 7):
        got, acc = tsamplers.step(torch.Generator().manual_seed(seed), state,
                                  tfn)
        want, _, _, acc1 = taff.run_stretch(
            tfn, pos0, torch.Generator().manual_seed(seed), 1)
        torch.testing.assert_close(got.pos, want.pos, rtol=0, atol=0)
        torch.testing.assert_close(got.lnp, want.lnp, rtol=0, atol=0)
        np.testing.assert_array_equal(acc.numpy(), acc1.numpy())
        assert 0 < acc.sum() < pos0.shape[0]


def test_step_pre_on_jax_draws_matches_jax_step():
    jfn, tfn, pos0 = _flagship()
    nh = pos0.shape[0] // 2
    jstate = jaff.EnsembleState(jnp.asarray(pos0), jfn(jnp.asarray(pos0)))
    tstate = taff.EnsembleState(torch.as_tensor(pos0),
                                tfn(torch.as_tensor(pos0)))
    for seed in (0, 3, 11):
        key = jax.random.PRNGKey(seed)
        jnew, jacc = jaff.step(key, jstate, jfn)
        # the draws of JAX's step, re-derived from its key
        k_z, k_j, k_a = jax.random.split(key, 3)
        u_z = jax.random.uniform(k_z, (2, nh), dtype=jnp.float64)
        j = jax.random.randint(k_j, (2, nh), 0, nh)
        ln_u = jnp.log(jax.random.uniform(k_a, (2, nh), dtype=jnp.float64))
        tnew, tacc = taff._step_pre(
            (_t(u_z), _t(j).long(), _t(ln_u)), tstate, tfn, 2.0)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        assert 0 < np.asarray(jacc).sum()
        _close(tnew.pos, jnew.pos)
        _close(tnew.lnp, jnew.lnp)
        jstate, tstate = jnew, tnew


def test_veff_lf_alias_and_console_script():
    from lumfuncmcmc_tpu_torch import LFConfig
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
    from lumfuncmcmc_tpu_torch.utils.synth import (
        apply_completeness_cut, make_catalog)

    cfg = LFConfig(min_comp_frac=0.5, size_ln=11, nboot=20, nbins=10)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=300, seed=4),
                                 cfg)
    m = LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                     flux_e=cat["flux_e"], field_id=cat["field_id"],
                     device="cpu", dtype=torch.float64)
    for got, want in zip(m.VeffLF(), m.veff_lf()):
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(m.Lavg).all() and len(m.Lavg) == cfg.nbins

    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["lumfuncmcmc-tpu"] == "lumfuncmcmc_tpu.cli.main:main"
    mod, attr = scripts["lumfuncmcmc-tpu-torch"].split(":")
    from lumfuncmcmc_tpu_torch.cli.main import main
    assert getattr(importlib.import_module(mod), attr) is main
