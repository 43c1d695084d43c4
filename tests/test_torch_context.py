"""PyTorch port vs JAX package: the frozen likelihood context.

``build_context`` is float64 numpy on the host in both packages, carried
over line for line, so every field agrees to rounding (rtol 1e-12) for
both quadratures, with and without a completeness cut."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.models.context import build_context as jax_build
from lumfuncmcmc_tpu.utils.synth import (
    apply_completeness_cut as jax_cut, make_catalog as jax_catalog)
from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
from lumfuncmcmc_tpu_torch.models.context import (
    CTX_FIELDS, build_context, context_from_arrays)
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

torch.set_num_threads(2)
RTOL = 1e-12


def _catalog(cfg, n=300, seed=5):
    return apply_completeness_cut(make_catalog(cfg, n_target=n, seed=seed),
                                  cfg)


def _arrays(jctx):
    out = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
           if f != "cosmo"}
    out["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                    for k in COSMO_FIELDS}
    return out


def _assert_ctx_equal(tctx, arrays, rtol=RTOL):
    for f in CTX_FIELDS:
        if f == "cosmo":
            for k in COSMO_FIELDS:
                np.testing.assert_allclose(
                    getattr(tctx.cosmo, k).numpy(), arrays["cosmo"][k],
                    rtol=rtol, err_msg=f"cosmo.{k}")
        elif f == "field_id":
            np.testing.assert_array_equal(tctx.field_id.numpy(),
                                          arrays[f])
        else:
            np.testing.assert_allclose(getattr(tctx, f).numpy(), arrays[f],
                                       rtol=rtol, err_msg=f)


def test_synthetic_catalog_matches_jax_package():
    cfg = LFConfig(min_comp_frac=0.5)
    got = _catalog(cfg)
    want = jax_cut(jax_catalog(cfg, n_target=300, seed=5), cfg)
    for k in ("z", "flux", "flux_e", "field_id", "true_lum"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("quadrature", ["trapz", "gauss"])
@pytest.mark.parametrize("mcf", [0.0, 0.5])
def test_build_context_matches_jax(quadrature, mcf):
    cfg = LFConfig(min_comp_frac=mcf, quadrature=quadrature, size_ln=23)
    cat = _catalog(cfg)
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"])
    jdata, jctx = jax_build(cfg, dtype=jnp.float64, **kw)
    tdata, tctx = build_context(cfg, **kw)
    _assert_ctx_equal(tctx, _arrays(jctx))
    for k in ("z", "lum", "lum_e", "flux", "flux_e"):
        np.testing.assert_allclose(getattr(tdata, k).numpy(),
                                   np.asarray(getattr(jdata, k)),
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(tdata.field_id.numpy(),
                                  np.asarray(jdata.field_id))


def test_build_context_from_luminosities_and_errors():
    """The lum/lum_e input route (and its flux back-propagation)."""
    cfg = LFConfig(min_comp_frac=0.5, fix_comp=True, size_ln=15)
    cat = _catalog(cfg, n=150)
    jdata, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                            dtype=jnp.float64, field_id=cat["field_id"])
    lum = np.asarray(jdata.lum)
    lum_e = np.full_like(lum, 0.05)
    kw = dict(z=cat["z"], lum=lum, lum_e=lum_e, field_id=cat["field_id"])
    jdata2, jctx2 = jax_build(cfg, dtype=jnp.float64, **kw)
    tdata2, tctx2 = build_context(cfg, **kw)
    _assert_ctx_equal(tctx2, _arrays(jctx2))
    np.testing.assert_allclose(tdata2.flux_e.numpy(),
                               np.asarray(jdata2.flux_e), rtol=RTOL)


def test_build_context_rejects_bad_field_ids():
    cfg = LFConfig(size_ln=11)
    cat = _catalog(cfg, n=60)
    fid = np.full(len(cat["z"]), 7)
    with pytest.raises(ValueError, match="Flim"):
        build_context(cfg, z=cat["z"], flux=cat["flux"], field_id=fid)
    with pytest.raises(ValueError, match="empty catalog"):
        build_context(cfg, z=np.zeros(0), flux=np.zeros(0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_context_from_arrays_round_trip(dtype):
    """JAX context -> numpy arrays -> port context keeps every field
    (exactly in float64, to float32 rounding in float32) and gives
    field_id as int64."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=17)
    cat = _catalog(cfg, n=200)
    _, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                        dtype=jnp.float64, field_id=cat["field_id"])
    arrays = _arrays(jctx)
    tctx = context_from_arrays(arrays, "cpu", dtype)
    assert tctx.field_id.dtype == torch.int64
    assert tctx.logL_grid.dtype == dtype
    _assert_ctx_equal(tctx, arrays,
                      rtol=0.0 if dtype == torch.float64 else 1e-7)
