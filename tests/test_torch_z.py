"""PyTorch port vs JAX package: the redshift-evolving (z) model.

Both sides compute on identical grids (``context_from_arrays``), on the
same numpy-seeded thetas. Tolerances:

- ``quad_coef`` / ``log_schechter_z``, float64: rtol 1e-12 (the same
  expression, evaluated by two libraries);
- the eager ``make_lnprob_z`` vs ``jax.vmap(make_lnprob_z)``, float64:
  rtol 1e-9 (sums of ~1e4 terms in another order);
- the plain ``z_lnlike_reference`` path in float32 vs JAX's
  ``make_pallas_lnprob_z`` in interpret mode, both layouts: rtol 5e-4
  against the float64 lnprob (the JAX package's own bar,
  ``tests/test_pallas.py``), for each and between the two;
- the plain ``z_lnlike_vg_reference`` path through the
  ``autograd.Function`` vs ``make_pallas_lnprob_and_grad(model="z")`` in
  interpret mode and vs float64 ``jax.value_and_grad``: values 5e-4,
  gradients by ``_grad_close`` at 2e-3;
- the plain value+grad columns vs ``torch.autograd`` of the plain value
  version, float64: 1e-9 (the same derivative, regrouped), at thetas
  where the ``x <= 60`` clamp of the source term never binds.
"""

import functools
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.models import likelihood_z as jz
from lumfuncmcmc_tpu.models.context import build_context as jax_build
from lumfuncmcmc_tpu.ops.pallas_lnlike import (
    make_pallas_lnprob_and_grad, make_pallas_lnprob_z)
from lumfuncmcmc_tpu.utils.synth import apply_completeness_cut, make_catalog
from lumfuncmcmc_tpu_torch import LFConfig as PortConfig
from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
from lumfuncmcmc_tpu_torch.models import likelihood_z as tz
from lumfuncmcmc_tpu_torch.models.context import (
    CTX_FIELDS, build_context, context_from_arrays)
from lumfuncmcmc_tpu_torch.models.likelihood import sample_init
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel, LumFuncModelZ
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.ops import schechter as tsch
from lumfuncmcmc_tpu_torch.utils import synth

# ``lumfuncmcmc_tpu.ops`` exports a function named ``schechter`` over
# its submodule of the same name
jsch = importlib.import_module("lumfuncmcmc_tpu.ops.schechter")

torch.set_num_threads(2)

Z_PARAMS = ["pivots", "natural"]


@functools.lru_cache(maxsize=None)
def _setup(z_param="pivots", fix_sch_al=False, size_ln=31, n=300, seed=6):
    cfg = LFConfig(min_comp_frac=0.5, fix_comp=True, size_ln=size_ln,
                   z_param=z_param, fix_sch_al=fix_sch_al)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=n, seed=seed),
                                 cfg)
    _, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    return cfg, jctx, jz.ThetaLayoutZ.from_config(cfg), arrays


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


def test_quad_coef_and_log_schechter_z_match_jax(rng):
    y = rng.uniform(-4.0, 44.0, (3, 50))
    zp = (1.20, 1.53, 1.86)
    got = tsch.quad_coef(*(torch.tensor(v) for v in y), *zp)
    want = jsch.quad_coef(*(jnp.asarray(v) for v in y), *zp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    logL = rng.uniform(40.0, 44.0, (7, 50))
    z = rng.uniform(1.1, 1.95, (7, 50))
    piv = rng.uniform(size=(7, 50)) * np.array(
        [1.5] * 3 + [2.0] * 3 + [1.0])[:, None] + np.array(
        [41.8] * 3 + [-4.0] * 3 + [-2.0])[:, None]
    args = [piv[6]] + list(piv[:6])
    got = tsch.log_schechter_z(torch.tensor(logL), torch.tensor(z),
                               *(torch.tensor(a) for a in args), *zp)
    want = jsch.log_schechter_z(jnp.asarray(logL), jnp.asarray(z),
                                *(jnp.asarray(a) for a in args), *zp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(
        tsch.schechter_z(torch.tensor(logL), torch.tensor(z),
                         *(torch.tensor(a) for a in args), *zp).numpy(),
        np.asarray(jsch.schechter_z(jnp.asarray(logL), jnp.asarray(z),
                                    *(jnp.asarray(a) for a in args), *zp)),
        rtol=1e-12)


@pytest.mark.parametrize("fix_sch_al", [False, True])
@pytest.mark.parametrize("z_param", Z_PARAMS)
def test_theta_layout_z_matches_jax(z_param, fix_sch_al, rng):
    cfg = LFConfig(z_param=z_param, fix_sch_al=fix_sch_al, z1=1.18, z2=1.36,
                   z3=1.54)
    jl = jz.ThetaLayoutZ.from_config(cfg)
    tl = tz.ThetaLayoutZ.from_config(
        PortConfig(z_param=z_param, fix_sch_al=fix_sch_al, z1=1.18, z2=1.36,
                   z3=1.54))
    assert tl.names == jl.names and tl.ndim == jl.ndim == 7 - fix_sch_al
    assert tl.lo == jl.lo and tl.hi == jl.hi
    assert (tl.z1, tl.z2, tl.z3, tl.natural) == (jl.z1, jl.z2, jl.z3,
                                                 jl.natural)
    assert tl.plot_names() == jl.plot_names()
    lo, hi = tl.bounds_arrays(torch.float64, "cpu")
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jl.lo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jl.hi))
    th = rng.uniform(jl.lo, jl.hi, (5, jl.ndim))
    got = tl.unpack(torch.tensor(th))
    for i, row in enumerate(th):
        want = jl.unpack(jnp.asarray(row))
        np.testing.assert_allclose([float(g[i]) for g in got],
                                   [float(w) for w in want], rtol=1e-14)


@pytest.mark.parametrize("z_param", Z_PARAMS)
def test_lnprior_z_is_strict_on_the_pivots_only(z_param):
    cfg = LFConfig(z_param=z_param)
    jl = jz.ThetaLayoutZ.from_config(cfg)
    tl = tz.ThetaLayoutZ.from_config(PortConfig(z_param=z_param))
    lo, hi = np.asarray(tl.lo), np.asarray(tl.hi)
    mid = 0.5 * (lo + hi)
    rows = [mid]
    for i in range(tl.ndim):
        for bound, inward in ((lo, 1.0), (hi, -1.0)):
            on = mid.copy()
            on[i] = bound[i]
            inside = mid.copy()
            inside[i] = bound[i] + inward * 1e-9 * (hi[i] - lo[i])
            rows += [on, inside]
    th = np.asarray(rows)
    got = tz.lnprior_z(torch.tensor(th), tl).numpy()
    want = np.asarray(jax.vmap(lambda t: jz.lnprior_z(t, jl))(
        jnp.asarray(th)))
    np.testing.assert_array_equal(got, want)
    # on a pivot bound: out; on the sch_al bound: in; just inside: in
    on_bound = got[1::2].reshape(tl.ndim, 2)
    assert np.isneginf(on_bound[:6]).all() and (on_bound[6] == 0).all()
    assert (got[2::2] == 0).all() and got[0] == 0


@pytest.mark.parametrize("fix_sch_al", [False, True])
@pytest.mark.parametrize("z_param", Z_PARAMS)
def test_make_lnprob_z_matches_jax(z_param, fix_sch_al):
    cfg, jctx, jl, arrays = _setup(z_param, fix_sch_al)
    tl = tz.ThetaLayoutZ.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    th = _central(tl, 12, 1, keep=0.5)
    th[3, 0] = 60.0                          # out of the box -> -inf
    got = tz.make_lnprob_z(ctx, tl)(torch.tensor(th)).numpy()
    want = np.asarray(jax.vmap(jz.make_lnprob_z(jctx, jl))(jnp.asarray(th)))
    assert np.isneginf(want[3]) and np.isfinite(np.delete(want, 3)).all()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9)
    lnpart, fullint = tz.lnlike_z_parts(torch.tensor(th[fin]), ctx, tl)
    jparts = jax.vmap(lambda t: jz.lnlike_z_parts(t, jctx, jl))(
        jnp.asarray(th[fin]))
    np.testing.assert_allclose(lnpart.numpy(), np.asarray(jparts[0]),
                               rtol=1e-9)
    np.testing.assert_allclose(fullint.numpy(), np.asarray(jparts[1]),
                               rtol=1e-9)


@pytest.mark.parametrize("flat", [True, False])
def test_plain_z_lnlike_matches_pallas_interpret(flat):
    """The thetas of ``tests/test_pallas.py::test_z_model_parity``."""
    cfg, jctx, jl, arrays = _setup()
    tl = tz.ThetaLayoutZ.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    rng = np.random.default_rng(11)
    th = np.column_stack(
        [rng.uniform(41.8, 43.5, (20, 3)), rng.uniform(-4, -1.5, (20, 3)),
         rng.uniform(-2, -0.8, (20, 1))]).astype(np.float32)
    th[3, 0] = 60.0
    fn = cl.make_cuda_lnprob_z(ctx, tl)
    assert fn.engine == "plain"
    got = fn(torch.tensor(th)).numpy()
    assert got.dtype == np.float32
    ref = np.asarray(jax.vmap(jz.make_lnprob_z(jctx, jl))(
        jnp.asarray(th, jnp.float64)))
    pal = np.asarray(make_pallas_lnprob_z(jctx, jl, interpret=True,
                                          flat=flat)(jnp.asarray(th)))
    fin = np.isfinite(ref)
    assert not fin[3]
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=5e-4)
    np.testing.assert_allclose(pal[fin], ref[fin], rtol=5e-4)
    np.testing.assert_allclose(got[fin], pal[fin], rtol=5e-4)


@pytest.mark.parametrize("z_param", Z_PARAMS)
def test_theta_value_and_grad_z_match_pallas_interpret_and_f64(z_param):
    cfg, jctx, jl, arrays = _setup(z_param)
    tl = tz.ThetaLayoutZ.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    fn = cl.make_cuda_lnprob_and_grad(ctx, tl, model="z")
    assert fn.engine == "plain"
    th = _central(tl, 5, 13)
    v, g = _port_vg(fn, th, torch.float32)
    pal = make_pallas_lnprob_and_grad(jctx, jl, interpret=True, model="z")
    pv, pg = jax.vmap(jax.value_and_grad(pal))(jnp.asarray(th, jnp.float32))
    jv, jg = jax.vmap(jax.value_and_grad(jz.make_lnprob_z(jctx, jl)))(
        jnp.asarray(th))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=5e-4)
    _grad_close(g, np.asarray(jg))
    np.testing.assert_allclose(v, np.asarray(pv), rtol=5e-4)
    _grad_close(g, np.asarray(pg))


@pytest.mark.parametrize("fix_sch_al", [False, True])
@pytest.mark.parametrize("z_param", Z_PARAMS)
def test_plain_z_paths_in_float64_match_jax(z_param, fix_sch_al):
    """In float64 the kernels' factored form (hoisted node rows, dz and
    lref-relative features) is the eager function regrouped: values and
    gradients at 1e-9."""
    cfg, jctx, jl, arrays = _setup(z_param, fix_sch_al)
    tl = tz.ThetaLayoutZ.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    th = _central(tl, 6, 2)
    jv, jg = jax.vmap(jax.value_and_grad(jz.make_lnprob_z(jctx, jl)))(
        jnp.asarray(th))
    for fn in (cl.make_cuda_lnprob_and_grad(ctx, tl, model="z"),
               tz.make_lnprob_z(ctx, tl)):
        v, g = _port_vg(fn, th, torch.float64)
        np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-9)
        _grad_close(g, np.asarray(jg), rtol=1e-9)
    np.testing.assert_allclose(
        cl.make_cuda_lnprob_z(ctx, tl)(torch.tensor(th)).numpy(),
        np.asarray(jv), rtol=1e-9)


def test_z_feature_gradient_columns_match_autograd():
    cfg, _, _, arrays = _setup()
    tl = tz.ThetaLayoutZ.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    data = cl.prepare_cuda_z_data(ctx, tl)
    feats = cl._features_z(torch.as_tensor(_central(tl, 7, 3)), data, tl,
                           torch.float64)
    rows = cl.z_lnlike_vg_reference(feats, data).numpy()
    assert rows.shape == (7, 8)
    f = feats.clone().requires_grad_(True)
    lnl = cl.z_lnlike_reference(f, data)
    (g,) = torch.autograd.grad(lnl.sum(), f)
    np.testing.assert_allclose(rows[:, 0], lnl.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(rows[:, 1:], g.numpy(), rtol=1e-9,
                               atol=1e-9 * np.abs(g.numpy()).max())
    # the wrappers take the plain versions for a CPU tensor
    np.testing.assert_array_equal(cl.z_lnlike_vg(feats, data).numpy(), rows)
    np.testing.assert_array_equal(cl.z_lnlike(feats, data).numpy(),
                                  lnl.detach().numpy())


def test_z_vg_source_term_clamps_x_and_the_value_version_does_not():
    """Lstar 28 dex below the brightest source: x = a - lq reaches 65.
    The value+grad version clamps x at 60 in the source term, as
    ``_kernel_z_vg`` does; the value version keeps the TPU value kernels'
    unclamped ``exp(x)``."""
    cfg, _, _, arrays = _setup()
    tl = tz.ThetaLayoutZ.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    data = cl.prepare_cuda_z_data(ctx, tl)
    feats = torch.tensor([[0.0, 0.0, -7.0, 0.0, 0.0, -65.0, -0.6]])
    x = (data.s_a + 65.0)[data.s_mask > 0]
    assert float(x.max()) > cl.X_CLAMP + 4.0
    rows = cl.z_lnlike_vg_reference(feats, data)
    value = cl.z_lnlike_reference(feats, data)
    assert torch.isfinite(rows).all() and torch.isfinite(value).all()
    # every grid cell underflows here, so the source sums are all there is
    clamped = torch.clamp(x, max=cl.X_CLAMP).double()
    want = ((-7.0 - 0.6 * clamped - torch.exp(clamped)).sum()
            + data.s_lnom0[data.s_mask > 0].double().sum())
    np.testing.assert_allclose(float(rows[0, 0]), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        float(rows[0, 6]), float((torch.exp(clamped) + 0.6).sum()),
        rtol=1e-5)
    assert float(value) < 10.0 * float(rows[0, 0]) < 0.0


def test_z_chunk_table_covers_every_cell_and_source_once():
    """The z model's two-pass launch table, which ``tools/vg_turns.py``
    rebuilds to run the earlier design of the z kernels."""
    spec = importlib.util.spec_from_file_location(
        "vg_turns", Path(__file__).parent.parent / "tools" / "vg_turns.py")
    vg_turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vg_turns)
    for shape, nsrc in (((5, 201, 201), 1672), ((2, 7, 300), 0),
                        ((3, 31, 31), 5000)):
        tab = vg_turns.z_chunk_table(shape, nsrc)
        nf, sl, sz = shape
        rows = np.zeros((nf, sl), int)
        src = np.zeros(nsrc, int)
        for f, a, b, is_src in tab:
            assert a < b
            if is_src:
                assert b - a <= cl.CHUNK_CELLS
                src[a:b] += 1
            else:
                assert (b - a) * sz <= max(cl.CHUNK_CELLS, sz)
                rows[f, a:b] += 1
        assert (rows == 1).all() and (src == 1).all()
    assert len(vg_turns.z_chunk_table((5, 201, 201), 1672)) == 5 * 21 + 1


@pytest.mark.parametrize("z_param", Z_PARAMS)
def test_masked_rows_give_minus_inf_and_an_exact_zero_gradient(z_param):
    cfg, _, _, arrays = _setup(z_param)
    tl = tz.ThetaLayoutZ.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    th = _central(tl, 5, 5)
    th[0, 0] = 1000.0                      # raw features would overflow
    th[1, 4] = tl.hi[4]                    # on a pivot bound: strict -> out
    th[2, 6] = tl.hi[6]                    # on the sch_al bound: in
    v, g = _port_vg(cl.make_cuda_lnprob_and_grad(ctx, tl, model="z"), th,
                    torch.float32)
    assert np.isneginf(v[:2]).all() and np.isfinite(v[2:]).all()
    np.testing.assert_array_equal(g[:2], 0.0)
    assert np.isfinite(g).all() and (g[2] != 0).all()
    np.testing.assert_array_equal(
        np.isfinite(cl.make_cuda_lnprob_z(ctx, tl)(
            torch.tensor(th, dtype=torch.float32)).numpy()),
        np.isfinite(v))


def test_z_wrappers_never_fall_back_to_the_plain_version():
    """A non-CPU tensor takes the kernel route or raises: a meta tensor
    and a fake CUDA tensor (no card here) both raise, and nothing is
    counted as a launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, _, _, arrays = _setup()
    tl = tz.ThetaLayoutZ.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    data = cl.prepare_cuda_z_data(ctx, tl)
    before = (cl.z_lnlike.launches, cl.z_lnlike_vg.launches)
    for fn in (cl.z_lnlike, cl.z_lnlike_vg):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.zeros((4, 7), device="meta"), data)
        with FakeTensorMode(allow_non_fake_inputs=True):
            with pytest.raises(ValueError, match="grid data on cpu"):
                fn(torch.zeros((4, 7), device="cuda"), data)
            with pytest.raises(TypeError, match="float32"):
                fn(torch.zeros((4, 7), device="cuda", dtype=torch.float64),
                   data)
            with pytest.raises(ValueError, match="features must be"):
                fn(torch.zeros((4, 8), device="cuda"), data)
    assert (cl.z_lnlike.launches, cl.z_lnlike_vg.launches) == before
    with pytest.raises(NotImplementedError, match="no kernel yet"):
        cl.make_cuda_lnprob_and_grad(ctx, tl, model="stream")


@functools.lru_cache(maxsize=None)
def _fit_sized(z_param):
    cfg = PortConfig(min_comp_frac=0.5, size_ln=41, fix_comp=True,
                     z_param=z_param)
    cat = synth.apply_completeness_cut(
        synth.make_catalog(cfg, n_target=2000, seed=cfg.seed), cfg)
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"], device="cpu")
    _, ctx32 = build_context(cfg, dtype=torch.float32, **kw)
    _, ctx64 = build_context(cfg, dtype=torch.float64, **kw)
    return cfg, cat, ctx32, ctx64


@pytest.mark.parametrize("z_param", Z_PARAMS)
def test_float32_z_gradient_on_the_fit_sized_catalog(z_param):
    """The float32 value+grad path on the port's own float32 context of
    the CLI's 2000-source synthetic catalog vs float64 autograd of the
    eager engine, at 256 prior draws shrunk toward the box centre: values
    rtol 5e-4, gradients by ``_grad_close``. The quadratics in ``z - z2``
    with ``lref``-relative luminosities, formed in float64, leave the
    gradient ~3e-5 from float64."""
    cfg, _, ctx32, ctx64 = _fit_sized(z_param)
    tl = tz.ThetaLayoutZ.from_config(cfg)
    lo, hi = tl.bounds_arrays(torch.float64, "cpu")
    gen = torch.Generator().manual_seed(2256)
    th = 0.7 * (lo + hi) / 2 + 0.3 * sample_init(
        gen, tl, 256, dtype=torch.float64, device="cpu")
    th = th.float().double().numpy()
    v, g = _port_vg(cl.make_cuda_lnprob_and_grad(ctx32, tl, model="z"), th,
                    torch.float32)
    eager = tz.make_lnprob_z(ctx64, tl)
    parts = [_port_vg(eager, th[i:i + 64], torch.float64)
             for i in range(0, 256, 64)]
    v64 = np.concatenate([p[0] for p in parts])
    g64 = np.concatenate([p[1] for p in parts])
    np.testing.assert_allclose(v, v64, rtol=5e-4)
    _grad_close(g, g64)
    _grad_close(g, g64, rtol=2e-4)     # what the feature layout buys


def test_float32_features_in_z_and_absolute_luminosities_lose_the_gradient():
    """Why the port's z features differ from the TPU kernels': on the
    fit-sized catalog the JAX package's float32 value+grad path (features
    quadratic in z, ``LN10 logL - LN10 Lstar(z)`` of two ~98-sized
    numbers; interpret mode) sits within a factor of a few of the 2e-3
    gradient gate at 32 prior-shrunk thetas, the port's float32 path on
    the same thetas and grids at least 10x closer to float64."""
    cfg, cat, _, _ = _fit_sized("pivots")
    jcfg = LFConfig(min_comp_frac=0.5, size_ln=41, fix_comp=True)
    _, jctx = jax_build(jcfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    jl = jz.ThetaLayoutZ.from_config(jcfg)
    tl = tz.ThetaLayoutZ.from_config(cfg)
    th = _central(tl, 32, 3)
    _, g64 = jax.vmap(jax.value_and_grad(jz.make_lnprob_z(jctx, jl)))(
        jnp.asarray(th))
    g64 = np.asarray(g64)
    pal = make_pallas_lnprob_and_grad(jctx, jl, interpret=True, model="z")
    _, gp = jax.vmap(jax.value_and_grad(pal))(jnp.asarray(th, jnp.float32))
    ctx32 = context_from_arrays(arrays, "cpu", torch.float32)
    _, g = _port_vg(cl.make_cuda_lnprob_and_grad(ctx32, tl, model="z"), th,
                    torch.float32)
    denom = np.maximum(np.abs(g64),
                       1e-3 * np.abs(g64).max(axis=-1, keepdims=True))
    err_tpu_form = float((np.abs(np.asarray(gp) - g64) / denom).max())
    err_port = float((np.abs(g - g64) / denom).max())
    assert err_tpu_form > 4e-4
    assert err_port < 0.1 * err_tpu_form


def _model(cls, cfg):
    cat = synth.apply_completeness_cut(
        synth.make_catalog(cfg, n_target=200, seed=3), cfg)
    return cls(cfg, z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
               field_id=cat["field_id"], device="cpu")


def test_z_model_starts_ignore_diff_rand_as_in_jax():
    """The JAX z model always draws every start coordinate on its own
    (only the single-epoch model passes ``cfg.diff_rand``); a config
    file that sets ``diff_rand`` to false must not collapse a ``fitz``
    run's starts onto the box diagonal."""
    cfg = PortConfig(min_comp_frac=0.5, size_ln=7, nwalkers=16,
                     diff_rand=False)
    gen = torch.Generator().manual_seed(1)
    mz = _model(LumFuncModelZ, cfg)
    assert mz.cfg.fix_comp and mz.model_kind == "z"
    pos = mz._initial_positions(gen)
    lo, hi = mz.layout.bounds_arrays(torch.float64, "cpu")
    u = ((pos - lo) / (hi - lo)).numpy()
    assert pos.shape == (16, 7) and np.ptp(u, axis=1).min() > 0.05
    ms = _model(LumFuncModel, cfg)
    pos = ms._initial_positions(gen)
    lo, hi = ms.layout.bounds_arrays(torch.float64, "cpu")
    u = ((pos - lo) / (hi - lo)).numpy()
    np.testing.assert_allclose(np.ptp(u, axis=1), 0.0, atol=1e-12)
    ms = _model(LumFuncModel, cfg.replace(diff_rand=True))
    u = ((ms._initial_positions(gen) - lo) / (hi - lo)).numpy()
    assert np.ptp(u, axis=1).min() > 0.05


@pytest.mark.parametrize("z_param", Z_PARAMS)
def test_z_model_engines_params_and_median_fit(z_param):
    cfg = PortConfig(min_comp_frac=0.5, size_ln=7, nwalkers=16,
                     z_param=z_param, z1=1.18, z2=1.36, z3=1.54)
    m = _model(LumFuncModelZ, cfg)
    assert m.lnprob_batch().engine == "eager"
    vals = m.get_params()
    want = ([cfg.Lstar, 0.0, 0.0, cfg.phistar, 0.0, 0.0] if z_param ==
            "natural" else [cfg.Lstar] * 3 + [cfg.phistar] * 3)
    assert vals == want + [cfg.sch_al] and m.nfreeparams == 7
    mp = _model(LumFuncModelZ, cfg.replace(use_pallas=True))
    th = torch.tensor(_central(m.layout, 4, 9))
    assert mp.lnprob_batch().engine == "plain"
    np.testing.assert_allclose(mp.lnprob_batch()(th).numpy(),
                               m.lnprob_batch()(th).numpy(), rtol=1e-9)
    # the median-theta LF matrix against the JAX package's schechter_z
    rng = np.random.default_rng(4)
    center = np.asarray(vals)
    m.samples = np.column_stack(
        [center + 0.05 * rng.standard_normal((400, 7)),
         -rng.uniform(0, 3, 400)])
    lf = m.set_median_fit(zlen=6, Llen=9)
    assert lf.shape == (6, 9) and m.zout.shape == (6,)
    assert m.Lout.shape == (9,) and np.isfinite(m.Lavg).all()
    jl = jz.ThetaLayoutZ.from_config(
        LFConfig(z_param=z_param, z1=1.18, z2=1.36, z3=1.54))
    piv = jl.unpack(jnp.asarray(np.percentile(m.samples[:, :-1], 50.0,
                                              axis=0)))
    zz, ll = np.meshgrid(m.zout, m.Lout, indexing="ij")
    want = jsch.schechter_z(jnp.asarray(ll), jnp.asarray(zz), piv[6],
                            *piv[:6], 1.18, 1.36, 1.54)
    np.testing.assert_allclose(lf, np.asarray(want), rtol=1e-10)
    np.testing.assert_allclose(m.zout[[0, -1]], [m.zmin, m.zmax])
