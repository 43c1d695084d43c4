"""PyTorch port vs JAX package: the likelihood engines.

Both sides compute on identical grids: the JAX context is carried into
the port with ``context_from_arrays``. Tolerances:

- eager ``make_lnprob`` vs ``jax.vmap(make_lnprob)``, float64: rtol 1e-9
  (the same formulas, summed in another order);
- the kernels' plain versions vs the same JAX oracle, float64: rtol 1e-8
  (the factored exponentials only regroup terms);
- the plain versions in float32 vs the JAX Pallas kernels in interpret
  mode: rtol 5e-4, the bar the JAX package holds its kernels to.

The -inf pattern (out-of-box thetas, negative Flim) must be identical.
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
from lumfuncmcmc_tpu.ops.pallas_lnlike import make_pallas_lnprob
from lumfuncmcmc_tpu.utils.synth import apply_completeness_cut, make_catalog
from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
from lumfuncmcmc_tpu_torch.models import likelihood as tlik
from lumfuncmcmc_tpu_torch.models.context import (
    CTX_FIELDS, context_from_arrays)
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.ops.schechter import LN10

torch.set_num_threads(2)

CASES = {
    "free": dict(),
    "fixed": dict(fix_comp=True),
    "fix_sch_al": dict(fix_sch_al=True),
    "fcmin0": dict(fcmin=0.0),
    "gauss": dict(quadrature="gauss", size_ln=12),
}


@functools.lru_cache(maxsize=None)
def _setup(case, size_ln=19, n=250, seed=11):
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


def _thetas(layout, w, seed):
    """Box draws plus one out-of-box theta and (free completeness) one
    negative Flim."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(layout.lo), np.asarray(layout.hi)
    th = lo + rng.uniform(size=(w, layout.ndim)) * (hi - lo)
    th[0, 0] = hi[0] + 1.0
    if not layout.fix_comp:
        th[min(5, w - 1), 2 if layout.fix_sch_al else 3] = -1.0
    return th


def _oracle(jctx, layout, th):
    return np.asarray(jax.jit(jax.vmap(jlik.make_lnprob(jctx, layout)))(
        jnp.asarray(th, jnp.float64)))


def _assert_same(got, want, rtol):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() >= len(want) - 2
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def test_theta_layout_matches_jax():
    for case in ("free", "fixed", "fix_sch_al"):
        cfg = LFConfig().replace(**CASES[case])
        t, j = tlik.ThetaLayout.from_config(cfg), \
            jlik.ThetaLayout.from_config(cfg)
        assert (t.names, t.lo, t.hi, t.plot_names()) == \
            (j.names, j.lo, j.hi, j.plot_names())
        th = _thetas(j, 6, 1)
        th[:, 3:3 + cfg.fix_comp * 0] = 2.0
        th = np.abs(th)
        got = t.unpack(torch.as_tensor(th))
        for i in range(6):
            want = j.unpack(jnp.asarray(th[i]))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                           rtol=1e-14)


@pytest.mark.parametrize("case", list(CASES))
def test_eager_lnprob_matches_jax(case):
    cfg, jctx, jlayout, arrays = _setup(case)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    th = _thetas(layout, 24, 3)
    got = tlik.make_lnprob(ctx, layout)(torch.as_tensor(th)).numpy()
    _assert_same(got, _oracle(jctx, jlayout, th), 1e-9)
    lp = tlik.lnprior(torch.as_tensor(th), layout).numpy()
    want_lp = np.asarray(jax.vmap(lambda t: jlik.lnprior(t, jlayout))(
        jnp.asarray(th)))
    np.testing.assert_array_equal(lp, want_lp)


@pytest.mark.parametrize("case", ["free", "fixed"])
def test_lnlike_parts_and_collapsed_term(case):
    cfg, jctx, jlayout, arrays = _setup(case, size_ln=15, n=150)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    th = np.abs(_thetas(layout, 8, 4))[1:]
    for collapse in (True, False):
        lnp, full = tlik.lnlike_single_epoch_parts(
            torch.as_tensor(th), ctx, layout, collapse=collapse)
        jl, jf = jax.jit(jax.vmap(
            lambda t: jlik.lnlike_single_epoch_parts(
                t, jctx, jlayout, collapse=collapse)))(jnp.asarray(th))
        np.testing.assert_allclose(lnp.numpy(), np.asarray(jl), rtol=1e-9)
        np.testing.assert_allclose(full.numpy(), np.asarray(jf), rtol=1e-9)
    if layout.fix_comp:
        lstar, phistar, sch_al, _, _ = layout.unpack(torch.as_tensor(th))
        np.testing.assert_allclose(
            tlik._ln_term_collapsed(ctx, lstar, phistar, sch_al).numpy(),
            tlik._ln_term_direct(ctx, lstar, phistar, sch_al,
                                 ctx.ln_om_src).numpy(), rtol=1e-9)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("w", [11, 24])
def test_plain_kernel_versions_match_jax_f64(case, w):
    cfg, jctx, jlayout, arrays = _setup(case)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    fn = cl.make_cuda_lnprob(ctx, layout)
    assert fn.engine == "plain"
    th = _thetas(layout, w, 10 + w)
    got = fn(torch.as_tensor(th)).numpy()
    _assert_same(got, _oracle(jctx, jlayout, th), 1e-8)


@pytest.mark.parametrize("case", ["free", "fixed", "fix_sch_al", "gauss"])
def test_plain_kernel_versions_match_pallas_interpret_f32(case):
    """fcmin=0 is left out: the JAX Pallas path raises ZeroDivisionError
    in its feature map there (the port sends t2 = 1, unused)."""
    cfg, jctx, jlayout, arrays = _setup(case, size_ln=13, n=150)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float32)
    th = _thetas(layout, 11, 7)
    got = cl.make_cuda_lnprob(ctx, layout)(
        torch.as_tensor(th, dtype=torch.float32)).numpy()
    want = np.asarray(make_pallas_lnprob(jctx, jlayout, interpret=True)(
        jnp.asarray(th, jnp.float32)))
    _assert_same(got, want, 5e-4)


def test_feature_maps_and_packing_match_pallas():
    """Feature rows and packed cell arrays equal the JAX package's
    (float32 there, float64 here) at float32 rounding; the port's
    luminosities ``g_a`` and feature ``lA`` are the JAX package's less
    ``LN10 * lref``."""
    from lumfuncmcmc_tpu.ops import pallas_lnlike as pl
    cfg, jctx, jlayout, arrays = _setup("free", size_ln=13, n=150)
    layout = tlik.ThetaLayout.from_config(cfg)
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    data = cl.prepare_cuda_data(ctx, False, cfg.fcmin)
    jdata = pl.prepare_pallas_data(jctx, False, flat=True)
    shift = {"g_a": LN10 * data.lref}
    for name in ("g_logf", "g_a", "g_p", "g_r", "g_w"):
        packed = np.asarray(getattr(jdata, name))[0]
        parts = [packed[o:o + (data.grid_off[f + 1] - data.grid_off[f])]
                 for f, (o, _) in enumerate(jdata.grid_rows)]
        np.testing.assert_allclose(
            getattr(data, name).numpy() + shift.get(name, 0.0),
            np.concatenate(parts), rtol=1e-6)
    th = np.abs(_thetas(layout, 9, 2))
    feats = cl._features(torch.as_tensor(th), data, layout, torch.float64)
    want = np.asarray(pl._features_free(
        pl._clamp_flim(jnp.asarray(th), jlayout), jlayout, jdata.lref,
        cfg.fcmin))
    got = feats.numpy()
    np.testing.assert_allclose(np.delete(got, 3, 1), np.delete(want, 3, 1),
                               rtol=1e-5)
    # lA: the same absolute allowance as rtol 1e-5 on JAX's LN10 * Lstar
    np.testing.assert_allclose(got[:, 3] + LN10 * data.lref, want[:, 3],
                               rtol=1e-5)
    # every cell and source appears in exactly one chunk
    ch = data.chunks.numpy()
    assert (ch[:, 2] - ch[:, 1] <= cl.CHUNK_CELLS).all()
    for is_src, off in ((0, data.grid_off), (1, data.src_off)):
        rows = ch[ch[:, 3] == is_src]
        assert (rows[:, 2] - rows[:, 1]).sum() == off[-1]
        for f, s, e, _ in rows:
            assert off[f] <= s < e <= off[f + 1]


def test_sample_init_inside_the_box():
    layout = tlik.ThetaLayout.from_config(LFConfig())
    gen = torch.Generator().manual_seed(0)
    pos = tlik.sample_init(gen, layout, 40)
    lo, hi = layout.bounds_arrays(torch.float64, "cpu")
    assert pos.shape == (40, layout.ndim)
    assert tlik.in_box(pos, lo, hi).all()
    same = tlik.sample_init(gen, layout, 40, diff_rand=False)
    u = (same - lo) / (hi - lo)
    np.testing.assert_allclose(u.numpy(), u[:, :1].expand(-1, layout.ndim
                                                          ).numpy(),
                               rtol=1e-12)
    with pytest.raises(NotImplementedError):
        tlik.make_lnprob(None, layout, exact_bounds=True)
