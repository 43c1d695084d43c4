"""PyTorch port vs JAX package: the value+gradient path of NUTS.

Both sides compute on identical grids (``context_from_arrays``).
Tolerances:

- the port's theta-level value+gradient through the plain value+grad
  versions (float32) vs JAX's ``make_pallas_lnprob_and_grad`` in
  interpret mode: values rtol 5e-4, gradients by ``_grad_close`` at 2e-3
  (the JAX package's own bars, ``tests/test_pallas.py``);
- the plain value+grad columns vs ``torch.autograd`` of the plain value
  versions, float64: 1e-9 (the same derivative, summed in another
  order), at thetas where the ``fc >= 1e-30`` clamp never binds;
- the plain value+grad path in float64, and the eager engine's
  autograd, vs ``jax.value_and_grad`` of the float64 XLA lnprob: 1e-9.

fcmin = 0 is left out against Pallas (its feature map raises
ZeroDivisionError there, ROADMAP §C) and compared with XLA instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.models import likelihood as jlik
from lumfuncmcmc_tpu.models.context import build_context as jax_build
from lumfuncmcmc_tpu.ops.pallas_lnlike import make_pallas_lnprob_and_grad
from lumfuncmcmc_tpu.utils.synth import apply_completeness_cut, make_catalog
from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
from lumfuncmcmc_tpu_torch.models import likelihood as tlik
from lumfuncmcmc_tpu_torch.models.context import (
    CTX_FIELDS, context_from_arrays)
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl

torch.set_num_threads(2)

CASES = {
    "free": dict(),
    "gauss": dict(quadrature="gauss", size_ln=10),
    "fixed": dict(fix_comp=True),
    "fcmin0": dict(fcmin=0.0),
    "fix_sch_al": dict(fix_sch_al=True),
}


@functools.lru_cache(maxsize=None)
def _setup(case, size_ln=13, n=150, seed=5):
    cfg = LFConfig(min_comp_frac=0.5, size_ln=size_ln).replace(**CASES[case])
    cat = apply_completeness_cut(make_catalog(cfg, n_target=n, seed=seed),
                                 cfg)
    _, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    return cfg, jctx, jlik.ThetaLayout.from_config(cfg), arrays


def _central(layout, w, seed, keep=0.3):
    """Prior draws shrunk toward the box centre (``tests/test_pallas.py``
    does the same): every completeness value stays far above the
    1e-30 clamp, which the analytic derivative ignores."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(layout.lo), np.asarray(layout.hi)
    th = lo + rng.uniform(size=(w, layout.ndim)) * (hi - lo)
    return (1 - keep) * 0.5 * (lo + hi)[None, :] + keep * th


def _grad_close(gp, gref, rtol=2e-3):
    """The JAX package's gradient gate (``tests/test_pallas.py:151``):
    relative per component, floored at 1e-3 of the row's largest."""
    denom = np.maximum(np.abs(gref),
                       1e-3 * np.abs(gref).max(axis=-1, keepdims=True))
    np.testing.assert_array_less(np.abs(gp - gref) / denom, rtol)


def _port_vg(fn, th, dtype):
    t = torch.tensor(th, dtype=dtype, requires_grad=True)
    v = fn(t)
    (g,) = torch.autograd.grad(v.sum(), t)
    return v.detach().numpy(), g.numpy()


@pytest.mark.parametrize("case", ["free", "gauss", "fixed"])
def test_theta_value_and_grad_match_pallas_interpret(case):
    cfg, jctx, jlayout, arrays = _setup(case)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    fn = cl.make_cuda_lnprob_and_grad(ctx, layout)
    assert fn.engine == "plain"
    th = _central(layout, 5, 1)
    v, g = _port_vg(fn, th, torch.float32)
    pal = make_pallas_lnprob_and_grad(jctx, jlayout, interpret=True)
    jv, jg = jax.vmap(jax.value_and_grad(pal))(jnp.asarray(th, jnp.float32))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=5e-4)
    _grad_close(g, np.asarray(jg))


@pytest.mark.parametrize("case", ["fcmin0", "fix_sch_al", "free"])
def test_theta_value_and_grad_match_xla_f64(case):
    """The plain value+grad path in float64 against ``jax.value_and_grad``
    of the XLA lnprob, fcmin = 0 included, both at 1e-9 (the analytic
    feature gradient only regroups the sums)."""
    cfg, jctx, jlayout, arrays = _setup(case)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    th = _central(layout, 6, 2)
    v, g = _port_vg(cl.make_cuda_lnprob_and_grad(ctx, layout), th,
                    torch.float64)
    jv, jg = jax.vmap(jax.value_and_grad(jlik.make_lnprob(jctx, jlayout)))(
        jnp.asarray(th))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-9)
    _grad_close(g, np.asarray(jg), rtol=1e-9)


@pytest.mark.parametrize("case", ["free", "fcmin0", "gauss", "fixed"])
def test_feature_gradient_columns_match_autograd(case):
    cfg, _, _, arrays = _setup(case)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    data = cl.prepare_cuda_data(ctx, layout.fix_comp, layout.fcmin)
    feats = cl._features(torch.as_tensor(_central(layout, 7, 3)), data,
                         layout, torch.float64)
    if layout.fix_comp:
        value, vg = cl.fixed_lnlike_reference, cl.fixed_lnlike_vg_reference
    else:
        value, vg = cl.free_lnlike_reference, cl.free_lnlike_vg_reference
    rows = vg(feats, data).numpy()
    assert rows.shape == (7, 1 + feats.shape[1])
    f = feats.clone().requires_grad_(True)
    lnl = value(f, data)
    (g,) = torch.autograd.grad(lnl.sum(), f)
    np.testing.assert_allclose(rows[:, 0], lnl.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(rows[:, 1:], g.numpy(), rtol=1e-9,
                               atol=1e-9 * np.abs(g.numpy()).max())
    if case == "fcmin0":                    # no t2 term: d_t2 is 0
        assert (rows[:, 7 + layout.nfields:] == 0).all()
    # the wrappers take the plain versions for a CPU tensor
    fn = cl.fixed_lnlike_vg if layout.fix_comp else cl.free_lnlike_vg
    np.testing.assert_array_equal(fn(feats, data).numpy(), rows)


@pytest.mark.parametrize("case", ["free", "fixed"])
def test_eager_engine_gradient_matches_jax(case):
    cfg, jctx, jlayout, arrays = _setup(case)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    th = _central(layout, 6, 4, keep=0.6)
    v, g = _port_vg(tlik.make_lnprob(ctx, layout), th, torch.float64)
    jv, jg = jax.vmap(jax.value_and_grad(jlik.make_lnprob(jctx, jlayout)))(
        jnp.asarray(th))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-9)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(jg)).max())


@pytest.mark.parametrize("case", ["free", "fixed"])
def test_out_of_box_theta_gives_minus_inf_and_zero_gradient(case):
    cfg, _, _, arrays = _setup(case)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    th = _central(layout, 4, 5)
    th[0, 0] = layout.hi[0] + 1.0
    if not layout.fix_comp:
        th[1, 3] = -1.0                         # negative Flim
    v, g = _port_vg(cl.make_cuda_lnprob_and_grad(ctx, layout), th,
                    torch.float32)
    assert np.isneginf(v[:2 - layout.fix_comp]).all()
    assert np.isfinite(v[2:]).all()
    np.testing.assert_array_equal(g[:2 - layout.fix_comp], 0.0)
    assert np.isfinite(g).all()


def test_vg_wrappers_never_fall_back_to_the_plain_version():
    """A non-CPU tensor takes the kernel route or raises: a meta tensor
    and a fake CUDA tensor (no card here) both raise, and nothing is
    counted as a launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, _, _, arrays = _setup("free")
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    data = cl.prepare_cuda_data(ctx, False, cfg.fcmin)
    fixed = cl.prepare_cuda_data(ctx, True)
    before = (cl.free_lnlike_vg.launches, cl.fixed_lnlike_vg.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        cl.free_lnlike_vg(torch.zeros((4, 16), device="meta"), data)
    with pytest.raises(ValueError, match="unsupported device"):
        cl.fixed_lnlike_vg(torch.zeros((4, 4), device="meta"), fixed)
    with FakeTensorMode(allow_non_fake_inputs=True):
        with pytest.raises(ValueError, match="grid data on cpu"):
            cl.free_lnlike_vg(torch.zeros((4, 16), device="cuda"), data)
        with pytest.raises(TypeError, match="float32"):
            cl.fixed_lnlike_vg(torch.zeros((4, 4), device="cuda",
                                           dtype=torch.float64), fixed)
    assert (cl.free_lnlike_vg.launches,
            cl.fixed_lnlike_vg.launches) == before


@pytest.mark.parametrize("fix_comp", [False, True])
def test_float32_gradient_on_the_fit_sized_catalog(fix_comp):
    """The float32 value+grad path on the port's own float32 context of
    the CLI's 2000-source synthetic catalog vs float64 autograd of the
    eager engine, at 256 prior draws shrunk toward the box centre: values
    rtol 5e-4, gradients by ``_grad_close``. Under fixed completeness the
    Lstar component is a difference of terms ~N ln10 in size, so the
    context's catalog sums must be taken against the float32 lref it
    carries: with the float64 anchor they missed the bar (3.5e-3)."""
    from lumfuncmcmc_tpu_torch import LFConfig as PortConfig
    from lumfuncmcmc_tpu_torch.models.context import build_context
    from lumfuncmcmc_tpu_torch.utils import synth
    cfg = PortConfig(min_comp_frac=0.5, size_ln=41, fix_comp=fix_comp)
    cat = synth.apply_completeness_cut(
        synth.make_catalog(cfg, n_target=2000, seed=cfg.seed), cfg)
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"], device="cpu")
    _, ctx32 = build_context(cfg, dtype=torch.float32, **kw)
    _, ctx64 = build_context(cfg, dtype=torch.float64, **kw)
    lref = float(ctx32.lref)
    np.testing.assert_allclose(
        float(ctx32.sum_pow_lum),
        float((10.0 ** (ctx64.lum - lref)).sum()), rtol=2e-7)
    layout = tlik.ThetaLayout.from_config(cfg)
    lo, hi = layout.bounds_arrays(torch.float64, "cpu")
    gen = torch.Generator().manual_seed(2256)
    th = 0.7 * (lo + hi) / 2 + 0.3 * tlik.sample_init(
        gen, layout, 256, dtype=torch.float64, device="cpu")
    th = th.float().double().numpy()
    v, g = _port_vg(cl.make_cuda_lnprob_and_grad(ctx32, layout), th,
                    torch.float32)
    v64, g64 = _port_vg(tlik.make_lnprob(ctx64, layout), th, torch.float64)
    np.testing.assert_allclose(v, v64, rtol=5e-4)
    _grad_close(g, g64)
