"""PyTorch port vs JAX package: the hierarchical multi-field model.

Both sides compute on identical grids (``context_from_arrays``), on the
same numpy-seeded thetas. Tolerances:

- ``ThetaLayoutH``: the same names, bounds and ``unpack`` (1e-14);
  ``lnz0_prior`` 1e-10 (the same numpy quadrature);
- the eager ``lnlike_h`` / ``lnlike_h_split`` / ``make_lnprob_h`` vs
  ``jax.vmap`` of the JAX ones, float64: rtol 1e-9 (sums of ~1e3 terms
  in another order);
- the plain ``hier_lnlike_reference`` path in float32 vs JAX's
  ``make_pallas_lnprob_h`` in interpret mode, both layouts: rtol 5e-4
  against the float64 lnprob (the JAX package's own bar,
  ``tests/test_pallas.py``), for each and between the two;
- the plain ``hier_lnlike_vg_reference`` path through the
  ``autograd.Function`` vs ``make_pallas_lnprob_and_grad(model="hier")``
  in interpret mode and vs float64 ``jax.value_and_grad``: values 5e-4,
  gradients by ``_grad_close`` at 2e-3;
- the plain value+grad columns vs ``torch.autograd`` of the plain value
  version, float64: 1e-9 (the same derivative, regrouped);
The ``fith`` CLI is compared in ``tests/test_torch_hier_cli.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.models import hierarchical as jh
from lumfuncmcmc_tpu.models.context import build_context as jax_build
from lumfuncmcmc_tpu.ops.pallas_lnlike import (
    _features_hier as tpu_features_hier, make_pallas_lnprob_and_grad,
    make_pallas_lnprob_h, prepare_pallas_data)
from lumfuncmcmc_tpu.utils.synth import apply_completeness_cut, make_catalog
from lumfuncmcmc_tpu_torch import LFConfig as PortConfig
from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
from lumfuncmcmc_tpu_torch.models import hierarchical as th_
from lumfuncmcmc_tpu_torch.models import likelihood as tl_
from lumfuncmcmc_tpu_torch.models.context import (
    CTX_FIELDS, build_context, context_from_arrays)
from lumfuncmcmc_tpu_torch.models.likelihood import sample_init
from lumfuncmcmc_tpu_torch.models.model import LumFuncModelH
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.ops.schechter import true_lum_func
from lumfuncmcmc_tpu_torch.utils import synth

torch.set_num_threads(2)

FSA = [False, True]


def _arrays(jctx):
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    return arrays


@functools.lru_cache(maxsize=None)
def _setup(fix_sch_al=False, size_ln=31, n=300, seed=6):
    cfg = LFConfig(min_comp_frac=0.5, fix_comp=True, size_ln=size_ln,
                   fix_sch_al=fix_sch_al)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=n, seed=seed),
                                 cfg)
    _, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        dtype=jnp.float64)
    return cfg, jctx, jh.ThetaLayoutH.from_config(cfg), _arrays(jctx)


def _central(layout, w, seed, keep=0.3):
    """Prior draws shrunk toward the box centre, where chains move."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(layout.lo), np.asarray(layout.hi)
    th = lo + rng.uniform(size=(w, layout.ndim)) * (hi - lo)
    th = (1 - keep) * 0.5 * (lo + hi)[None, :] + keep * th
    return th.astype(np.float32).astype(np.float64)   # exact in float32


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


@pytest.mark.parametrize("fix_sch_al", FSA)
def test_theta_layout_h_matches_jax(fix_sch_al, rng):
    jl = jh.ThetaLayoutH.from_config(LFConfig(fix_sch_al=fix_sch_al))
    tl = th_.ThetaLayoutH.from_config(PortConfig(fix_sch_al=fix_sch_al))
    assert tl.names == jl.names and tl.ndim == jl.ndim == 15 - fix_sch_al
    assert tl.lo == jl.lo and tl.hi == jl.hi
    assert (tl.nfields, tl.fix_sch_al, tl.sch_al0) == (
        jl.nfields, jl.fix_sch_al, jl.sch_al0)
    assert tl.plot_names() == jl.plot_names()
    lo, hi = tl.bounds_arrays(torch.float64, "cpu")
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jl.lo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jl.hi))
    th = rng.uniform(jl.lo, jl.hi, (5, jl.ndim))
    got = tl.unpack(torch.tensor(th))
    for i, row in enumerate(th):
        want = jl.unpack(jnp.asarray(row))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=1e-14)


@pytest.mark.parametrize("fix_sch_al", FSA)
def test_make_lnprob_h_matches_jax(fix_sch_al):
    cfg, jctx, jl, arrays = _setup(fix_sch_al)
    tl = th_.ThetaLayoutH.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    th = _central(tl, 12, 1, keep=0.5)
    th[3, 0] = 60.0                          # out of the box -> -inf
    th[5, 1] = 0.0                           # sig_L = 0: out, 1/sig
    th[7, 3] = -0.5                          # sig_p < 0: out, ln(sig)
    th[8, 1] = tl.lo[1]                      # on the bound: in
    bad = [3, 5, 7]
    got = th_.make_lnprob_h(ctx, tl)(torch.tensor(th)).numpy()
    want = np.asarray(jax.vmap(jh.make_lnprob_h(jctx, jl))(jnp.asarray(th)))
    fin = np.isfinite(want)
    assert not fin[bad].any() and fin.sum() == 9
    np.testing.assert_array_equal(np.isneginf(got), ~fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9)
    np.testing.assert_array_equal(
        th_.lnprior_h(torch.tensor(th), tl).numpy(),
        np.where(fin, 0.0, -np.inf))
    t = torch.tensor(th[fin])
    data, hyper = th_.lnlike_h_split(t, ctx, tl)
    jdata, jhyper = jax.vmap(lambda x: jh.lnlike_h_split(x, jctx, jl))(
        jnp.asarray(th[fin]))
    np.testing.assert_allclose(data.numpy(), np.asarray(jdata), rtol=1e-9)
    np.testing.assert_allclose(hyper.numpy(), np.asarray(jhyper), rtol=1e-9)
    np.testing.assert_allclose(th_.lnlike_h(t, ctx, tl).numpy(), want[fin],
                               rtol=1e-9)


@pytest.mark.parametrize("fix_sch_al", FSA)
def test_lnz0_prior_matches_jax(fix_sch_al):
    cfg = LFConfig(fix_sch_al=fix_sch_al)
    jl = jh.ThetaLayoutH.from_config(cfg)
    tl = th_.ThetaLayoutH.from_config(PortConfig(fix_sch_al=fix_sch_al))
    np.testing.assert_allclose(th_.lnz0_prior(tl), jh.lnz0_prior(jl),
                               rtol=1e-10)
    np.testing.assert_allclose(
        th_._box_mass_integral(40.0, 45.0, 0.01, 2.0, 40.0, 45.0, 3),
        jh._box_mass_integral(40.0, 45.0, 0.01, 2.0, 40.0, 45.0, 3),
        rtol=1e-10)
    x = np.linspace(-6, 6, 25)
    np.testing.assert_allclose(th_._gauss_cdf(x), jh._gauss_cdf(x),
                               rtol=1e-14)


def test_reduces_to_single_epoch_when_tied():
    """With all per-field params equal, ``lnlike_h`` equals the
    single-epoch lnlike plus the hyperprior at zero deviation (the
    identity of ``tests/test_hierarchical.py``), in every engine."""
    cfg, _, _, arrays = _setup()
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    lh = th_.ThetaLayoutH.from_config(cfg)
    ls_ = tl_.ThetaLayout.from_config(cfg)
    ls, ps, al, sig_l, sig_p = 42.6, -2.8, -1.5, 0.3, 0.5
    nf = lh.nfields
    t_h = torch.tensor([[ls, sig_l, ps, sig_p, al] + [ls] * nf + [ps] * nf],
                       dtype=torch.float64)
    base = float(tl_.lnlike_single_epoch(
        torch.tensor([[ls, ps, al]], dtype=torch.float64), ctx, ls_))
    hyper = nf * (-np.log(2 * np.pi) - np.log(sig_l) - np.log(sig_p))
    for fn in (lambda t: th_.lnlike_h(t, ctx, lh),
               cl.make_cuda_lnprob_h(ctx, lh),
               cl.make_cuda_lnprob_and_grad(ctx, lh, model="hier")):
        np.testing.assert_allclose(float(fn(t_h)), base + hyper, rtol=1e-10)


@pytest.mark.parametrize("flat", [True, False])
def test_plain_hier_lnlike_matches_pallas_interpret(flat):
    cfg, jctx, jl, arrays = _setup()
    tl = th_.ThetaLayoutH.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    th = _central(tl, 20, 11, keep=0.5).astype(np.float32)
    th[3, 0] = 60.0
    th[4, 1] = -1.0
    fn = cl.make_cuda_lnprob_h(ctx, tl)
    assert fn.engine == "plain"
    got = fn(torch.tensor(th)).numpy()
    assert got.dtype == np.float32
    ref = np.asarray(jax.vmap(jh.make_lnprob_h(jctx, jl))(
        jnp.asarray(th, jnp.float64)))
    pal = np.asarray(make_pallas_lnprob_h(jctx, jl, interpret=True,
                                          flat=flat)(jnp.asarray(th)))
    fin = np.isfinite(ref)
    assert not fin[3] and not fin[4] and fin.sum() == 18
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=5e-4)
    np.testing.assert_allclose(pal[fin], ref[fin], rtol=5e-4)
    np.testing.assert_allclose(got[fin], pal[fin], rtol=5e-4)


@pytest.mark.parametrize("fix_sch_al", FSA)
def test_theta_value_and_grad_h_match_pallas_interpret_and_f64(fix_sch_al):
    cfg, jctx, jl, arrays = _setup(fix_sch_al)
    tl = th_.ThetaLayoutH.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    fn = cl.make_cuda_lnprob_and_grad(ctx, tl, model="hier")
    assert fn.engine == "plain"
    th = _central(tl, 5, 13)
    v, g = _port_vg(fn, th, torch.float32)
    pal = make_pallas_lnprob_and_grad(jctx, jl, interpret=True,
                                      model="hier")
    pv, pg = jax.vmap(jax.value_and_grad(pal))(jnp.asarray(th, jnp.float32))
    jv, jg = jax.vmap(jax.value_and_grad(jh.make_lnprob_h(jctx, jl)))(
        jnp.asarray(th))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=5e-4)
    _grad_close(g, np.asarray(jg))
    np.testing.assert_allclose(v, np.asarray(pv), rtol=5e-4)
    _grad_close(g, np.asarray(pg))


@pytest.mark.parametrize("fix_sch_al", FSA)
def test_plain_h_paths_in_float64_match_jax(fix_sch_al):
    """In float64 the kernels' factored form (per-field features,
    lref-relative luminosities and catalog sums) is the eager function
    regrouped: values and gradients at 1e-9."""
    cfg, jctx, jl, arrays = _setup(fix_sch_al)
    tl = th_.ThetaLayoutH.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    th = _central(tl, 6, 2)
    jv, jg = jax.vmap(jax.value_and_grad(jh.make_lnprob_h(jctx, jl)))(
        jnp.asarray(th))
    for fn in (cl.make_cuda_lnprob_and_grad(ctx, tl, model="hier"),
               th_.make_lnprob_h(ctx, tl)):
        v, g = _port_vg(fn, th, torch.float64)
        np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-9)
        _grad_close(g, np.asarray(jg), rtol=1e-9)
    np.testing.assert_allclose(
        cl.make_cuda_lnprob_h(ctx, tl)(torch.tensor(th)).numpy(),
        np.asarray(jv), rtol=1e-9)


@pytest.mark.parametrize("fix_sch_al", FSA)
def test_h_feature_gradient_columns_match_autograd(fix_sch_al):
    cfg, _, _, arrays = _setup(fix_sch_al)
    tl = th_.ThetaLayoutH.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    data = cl.prepare_cuda_h_data(ctx, tl)
    nf = tl.nfields
    feats = cl._features_hier(torch.as_tensor(_central(tl, 7, 3)), data, tl,
                              torch.float64)
    assert feats.shape == (7, 1 + 3 * nf)
    rows = cl.hier_lnlike_vg_reference(feats, data).numpy()
    assert rows.shape == (7, 2 + 3 * nf)
    f = feats.clone().requires_grad_(True)
    lnl = cl.hier_lnlike_reference(f, data)
    (g,) = torch.autograd.grad(lnl.sum(), f)
    np.testing.assert_allclose(rows[:, 0], lnl.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(rows[:, 1:], g.numpy(), rtol=1e-9,
                               atol=1e-9 * np.abs(g.numpy()).max())
    # the wrappers take the plain versions for a CPU tensor
    np.testing.assert_array_equal(cl.hier_lnlike_vg(feats, data).numpy(),
                                  rows)
    np.testing.assert_array_equal(cl.hier_lnlike(feats, data).numpy(),
                                  lnl.detach().numpy())
    # each launch table cuts every field's cells, and no sources
    for _, tab, _ in data.vg_tables:
        tab = tab.numpy()
        assert (tab[:, 3] == 0).all()
        cover = np.zeros(data.g_a.numel(), int)
        for fld, a, b, _ in tab:
            assert data.grid_off[fld] <= a < b <= data.grid_off[fld + 1]
            cover[a:b] += 1
        assert (cover == 1).all()


def test_per_field_sums_add_up_to_the_catalog_sums():
    cfg, _, _, arrays = _setup()
    tl = th_.ThetaLayoutH.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    data = cl.prepare_cuda_h_data(ctx, tl)
    assert data.ln_sums_f.shape == (4, tl.nfields)
    assert data.ln_sums_f.dtype == torch.float64
    np.testing.assert_allclose(data.ln_sums_f.sum(dim=1).numpy(),
                               np.asarray(data.ln_sums), rtol=1e-12)
    np.testing.assert_allclose(data.ln_sums_f[0].numpy(),
                               arrays["nsrc_f"], rtol=0)
    np.testing.assert_allclose(
        data.ln_sums_f[1].numpy(),
        arrays["sum_lum_f"] - arrays["nsrc_f"] * data.lref, rtol=1e-9)
    np.testing.assert_allclose(data.ln_sums_f[2].numpy(),
                               arrays["sum_pow_lum_f"], rtol=1e-12)
    np.testing.assert_allclose(data.ln_sums_f[3].numpy(),
                               arrays["sum_ln_om_f"], rtol=1e-12)


@pytest.mark.parametrize("fix_sch_al", FSA)
def test_masked_h_rows_give_minus_inf_and_an_exact_zero_gradient(fix_sch_al):
    cfg, _, _, arrays = _setup(fix_sch_al)
    tl = th_.ThetaLayoutH.from_config(cfg)
    ctx32 = context_from_arrays(arrays, "cpu", torch.float32)
    ctx64 = context_from_arrays(arrays, "cpu", torch.float64)
    th = _central(tl, 6, 5)
    k = 4 if fix_sch_al else 5
    th[0, k] = 1000.0                  # Lstar_0: raw t1 would underflow
    th[1, k] = -1000.0                 # ... and overflow
    th[2, 1] = 0.0                     # sig_L = 0
    th[3, 3] = -2.0                    # sig_p < 0
    th[4, 1] = tl.lo[1]                # on the sig_L bound: in (the
    #                                    clamp stops that one gradient)
    for fn, dtype in ((cl.make_cuda_lnprob_and_grad(ctx32, tl, "hier"),
                       torch.float32),
                      (th_.make_lnprob_h(ctx64, tl), torch.float64)):
        v, g = _port_vg(fn, th, dtype)
        assert np.isneginf(v[:4]).all() and np.isfinite(v[4:]).all()
        np.testing.assert_array_equal(g[:4], 0.0)
        assert np.isfinite(g).all() and (g[5:] != 0).all()
        assert (np.delete(g[4], 1) != 0).all()
    np.testing.assert_array_equal(
        np.isfinite(cl.make_cuda_lnprob_h(ctx32, tl)(
            torch.tensor(th, dtype=torch.float32)).numpy()),
        np.isfinite(v))


def test_h_wrappers_never_fall_back_to_the_plain_version():
    """A non-CPU tensor takes the kernel route or raises: a meta tensor
    and a fake CUDA tensor (no card here) both raise, and nothing is
    counted as a launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, _, _, arrays = _setup()
    tl = th_.ThetaLayoutH.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    data = cl.prepare_cuda_h_data(ctx, tl)
    nfeat = 1 + 3 * tl.nfields
    before = (cl.hier_lnlike.launches, cl.hier_lnlike_vg.launches)
    for fn in (cl.hier_lnlike, cl.hier_lnlike_vg):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.zeros((4, nfeat), device="meta"), data)
        with FakeTensorMode(allow_non_fake_inputs=True):
            with pytest.raises(ValueError, match="grid data on cpu"):
                fn(torch.zeros((4, nfeat), device="cuda"), data)
            with pytest.raises(TypeError, match="float32"):
                fn(torch.zeros((4, nfeat), device="cuda",
                               dtype=torch.float64), data)
            with pytest.raises(ValueError, match="features must be"):
                fn(torch.zeros((4, 5), device="cuda"), data)
    assert (cl.hier_lnlike.launches, cl.hier_lnlike_vg.launches) == before
    with pytest.raises(NotImplementedError, match="no kernel yet"):
        cl.make_cuda_lnprob_and_grad(ctx, tl, model="stream")


@functools.lru_cache(maxsize=None)
def _fit_sized():
    cfg = PortConfig(min_comp_frac=0.5, size_ln=41, fix_comp=True)
    cat = synth.apply_completeness_cut(
        synth.make_catalog(cfg, n_target=2000, seed=cfg.seed), cfg)
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"], device="cpu")
    _, ctx32 = build_context(cfg, dtype=torch.float32, **kw)
    _, ctx64 = build_context(cfg, dtype=torch.float64, **kw)
    return cfg, cat, ctx32, ctx64


def _fit_sized_thetas(tl, w=256):
    lo, hi = tl.bounds_arrays(torch.float64, "cpu")
    gen = torch.Generator().manual_seed(2256)
    th = 0.7 * (lo + hi) / 2 + 0.3 * sample_init(
        gen, tl, w, dtype=torch.float64, device="cpu")
    return th.float().double().numpy()


def _eager64_vg(ctx64, tl, th):
    eager = th_.make_lnprob_h(ctx64, tl)
    parts = [_port_vg(eager, th[i:i + 64], torch.float64)
             for i in range(0, len(th), 64)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def test_float32_h_gradient_on_the_fit_sized_catalog():
    """The float32 value+grad path on the port's own float32 context of
    the CLI's 2000-source synthetic catalog vs float64 autograd of the
    eager engine, at 256 prior draws shrunk toward the box centre: values
    rtol 5e-4, gradients by ``_grad_close``. With ``lref``-relative
    luminosities and per-field sums, and ``lnrest`` formed in float64,
    the gradient sits well inside the gate."""
    cfg, _, ctx32, ctx64 = _fit_sized()
    tl = th_.ThetaLayoutH.from_config(cfg)
    th = _fit_sized_thetas(tl)
    v, g = _port_vg(cl.make_cuda_lnprob_and_grad(ctx32, tl, model="hier"),
                    th, torch.float32)
    v64, g64 = _eager64_vg(ctx64, tl, th)
    np.testing.assert_allclose(v, v64, rtol=5e-4)
    _grad_close(g, g64)
    _grad_close(g, g64, rtol=2e-4)     # what the feature layout buys


def test_tpu_form_float32_h_features_are_an_order_less_exact():
    """Why the port's hierarchical features differ from the TPU kernels':
    on the fit-sized catalog, at 32 prior-shrunk thetas, each form's
    float32 features against float64. The TPU's (``_features_hier`` on a
    float32 context, as a TPU run takes it: absolute luminosities, ``LN10
    logL - LN10 Lstar_f`` of two ~98-sized numbers, and ``lnrest`` summed
    in float32 as a feature) against the port's
    (``lref``-relative luminosities; ``lnrest`` in float64 from the
    rounded features): every field's grid integral taken with the exact
    exp of each form's float32 exponent, and ``lnrest``. The port's are
    at least 10x closer to float64 in both."""
    cfg, cat, _, _ = _fit_sized()
    jcfg = LFConfig(min_comp_frac=0.5, size_ln=41, fix_comp=True)
    jctx, jctx32 = (jax_build(jcfg, z=cat["z"], flux=cat["flux"],
                              flux_e=cat["flux_e"],
                              field_id=cat["field_id"], dtype=dt)[1]
                    for dt in (jnp.float64, jnp.float32))
    jl = jh.ThetaLayoutH.from_config(jcfg)
    tl = th_.ThetaLayoutH.from_config(cfg)
    th = _central(tl, 32, 3)
    tpu = np.asarray(tpu_features_hier(jnp.asarray(th, jnp.float32), jctx32,
                                       jl, float(jctx32.lref)))
    assert tpu.dtype == np.float32
    tpu_grid = prepare_pallas_data(jctx32, fix_comp=True, flat=True)
    ctx = context_from_arrays(_arrays(jctx), "cpu", torch.float64)
    data64 = cl.prepare_cuda_h_data(ctx, tl)
    data = cl.prepare_cuda_h_data(ctx, tl, dtype=torch.float32)
    t = torch.tensor(th)
    port = cl._features_hier(t, data, tl, torch.float32)
    _, _, _, _, sch_al, lstar, phistar = (
        np.asarray(x) for x in tl.unpack(t))
    logL = np.asarray(jctx.logL_grid, dtype=np.float64)
    w = np.asarray(jctx.w_fixed, dtype=np.float64) * np.log(10.0)
    ln10 = np.log(10.0)

    def integral(e, f):
        return (np.exp(e.astype(np.float64)) * w[f].ravel()).sum(axis=1)

    pf = port.float().numpy()
    err_tpu = err_port = 0.0
    for f in range(tl.nfields):
        ll = logL[f].ravel()[None, :]
        want = integral(ln10 * phistar[:, f:f + 1]
                        + (sch_al[:, None] + 1.0) * ln10
                        * (ll - lstar[:, f:f + 1])
                        - 10.0 ** (ll - lstar[:, f:f + 1]), f)
        at = tpu_grid.grid_rows[f][0]
        ga = np.asarray(tpu_grid.g_a, np.float32)[:, at:at + ll.size]
        gp = np.asarray(tpu_grid.g_p, np.float32)[:, at:at + ll.size]
        c, lA, t1 = (tpu[:, 2 + 3 * f + i:3 + 3 * f + i] for i in range(3))
        e = c + tpu[:, :1] * (ga - lA) - gp * t1
        err_tpu = max(err_tpu, float(np.abs(integral(e, f) - want).max()))
        g = slice(data.grid_off[f], data.grid_off[f + 1])
        c, lA, t1 = (pf[:, 1 + 3 * f + i:2 + 3 * f + i] for i in range(3))
        e = (c + pf[:, :1] * (data.g_a[g].numpy()[None, :] - lA)
             - data.g_p[g].numpy()[None, :] * t1)
        err_port = max(err_port, float(np.abs(integral(e, f) - want).max()))
    lnrest = cl._hier_collapsed(cl._features_hier(t, data64, tl,
                                                  torch.float64),
                                t, data64, tl).numpy()
    rest_tpu = float(np.abs(tpu[:, 1].astype(np.float64) - lnrest).max())
    rest_port = float(np.abs(cl._hier_collapsed(port, t, data, tl).numpy()
                             - lnrest).max())
    assert err_port * 10 < err_tpu, (err_port, err_tpu)
    assert rest_port * 10 < rest_tpu, (rest_port, rest_tpu)


def test_h_model_starts_ignore_diff_rand_as_in_jax():
    """``LumFuncModelH`` draws every start coordinate on its own, like
    the JAX one (``_BaseModel._default_positions``): a config that sets
    ``diff_rand`` to false must not collapse a ``fith`` run's starts onto
    the box diagonal."""
    cfg = PortConfig(min_comp_frac=0.5, size_ln=7, nwalkers=16,
                     diff_rand=False)
    m = _model(cfg)
    assert m.cfg.fix_comp and m.model_kind == "hier"
    pos = m._initial_positions(torch.Generator().manual_seed(1))
    lo, hi = m.layout.bounds_arrays(torch.float64, "cpu")
    u = ((pos - lo) / (hi - lo)).numpy()
    assert pos.shape == (16, 15) and np.ptp(u, axis=1).min() > 0.05


def _model(cfg):
    cat = synth.apply_completeness_cut(
        synth.make_catalog(cfg, n_target=200, seed=3), cfg)
    return LumFuncModelH(cfg, z=cat["z"], flux=cat["flux"],
                         flux_e=cat["flux_e"], field_id=cat["field_id"],
                         device="cpu")


@pytest.mark.parametrize("fix_sch_al", FSA)
def test_h_model_engines_params_and_median_fit(fix_sch_al):
    cfg = PortConfig(min_comp_frac=0.5, size_ln=7, nwalkers=16,
                     fix_sch_al=fix_sch_al)
    m = _model(cfg)
    assert m.lnprob_batch().engine == "eager"
    vals = m.get_params()
    nf = m.layout.nfields
    want = ([cfg.Lstar, 0.3, cfg.phistar, 0.5]
            + ([] if fix_sch_al else [cfg.sch_al])
            + [cfg.Lstar] * nf + [cfg.phistar] * nf)
    assert vals == want and m.nfreeparams == 15 - fix_sch_al
    mp = _model(cfg.replace(use_pallas=True))
    th = torch.tensor(_central(m.layout, 4, 9))
    assert mp.lnprob_batch().engine == "plain"
    np.testing.assert_allclose(mp.lnprob_batch()(th).numpy(),
                               m.lnprob_batch()(th).numpy(), rtol=1e-9)
    # the median LF at the population means
    rng = np.random.default_rng(4)
    d = len(vals)
    m.samples = np.column_stack(
        [np.asarray(vals) + 0.05 * rng.standard_normal((400, d)),
         -rng.uniform(0, 3, 400)])
    lf = m.set_median_fit(rndsamples=50)
    assert lf.shape == m.lum.shape and np.isfinite(m.Lavg).all()
    idx = np.random.default_rng(cfg.seed + 2).integers(0, 400, 50)
    draws = torch.tensor(m.samples[idx, :-1])
    al = (torch.full((50, 1), cfg.sch_al, dtype=torch.float64) if fix_sch_al
          else draws[:, 4:5])
    want = true_lum_func(torch.tensor(m.lum), al, draws[:, 0:1],
                         draws[:, 2:3]).numpy()
    np.testing.assert_allclose(lf, np.median(want, axis=0), rtol=1e-10)
