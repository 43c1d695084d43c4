"""PyTorch port vs JAX package: the accept step's precision of the resident
kernels of ``fit -fc``, ``fitz`` and ``fith`` past the float32 crossing,
and the refusal of a float32 run there.

On the 170,455-source catalog (``make_catalog(n_target=200_000, seed=7)``
after the completeness cut, gauss-32) the kernels' plain float32 versions
run on a float64 context as a float64 run takes them on the card: float32
features rounded from float64 thetas, float32 terms summed in float64, the
collapsed ln-terms (fixed: ``lnpart``; hierarchical: ``lnrest``) added on
the host in float64 from the same rounded features. Against the JAX
package's float64 lnprob on the same numpy inputs, the error in the lnp
differences of 32 close theta pairs near the truth is held to 0.02 (the
sampler's accept step bears 0.05); before float64 values and host-side
collapsed terms it was 0.27 (fixed), 0.50 (z) and 0.40 (hierarchical).

A run that is not float64 is refused from ``FLOAT32_MAX_SOURCES`` sources
on, for every family and engine: its lnp, cast to float32 at |lnL| ~ 15 N,
errs by up to a float32 spacing there.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.config import LFConfig
from lumfuncmcmc_tpu.models import hierarchical as jh
from lumfuncmcmc_tpu.models import likelihood as jlik
from lumfuncmcmc_tpu.models import likelihood_z as jz
from lumfuncmcmc_tpu.models.context import build_context as jax_build
from lumfuncmcmc_tpu.utils.synth import apply_completeness_cut, make_catalog
from lumfuncmcmc_tpu_torch import LFConfig as PortConfig
from lumfuncmcmc_tpu_torch.cli.main import main as port_main
from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
from lumfuncmcmc_tpu_torch.models import hierarchical as th_
from lumfuncmcmc_tpu_torch.models import likelihood as tlik
from lumfuncmcmc_tpu_torch.models import likelihood_z as tz
from lumfuncmcmc_tpu_torch.models.context import (
    CTX_FIELDS, context_from_arrays)
from lumfuncmcmc_tpu_torch.models.model import (
    LumFuncModel, LumFuncModelH, LumFuncModelZ)
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.utils import synth as tsynth

torch.set_num_threads(2)
DLNP_TOL = 0.02
# family -> (JAX layout, JAX lnprob, port layout, kernel model, model class)
FAMILIES = {
    "fixed": (jlik.ThetaLayout, jlik.make_lnprob, tlik.ThetaLayout,
              "single", LumFuncModel),
    "z": (jz.ThetaLayoutZ, jz.make_lnprob_z, tz.ThetaLayoutZ, "z",
          LumFuncModelZ),
    "hier": (jh.ThetaLayoutH, jh.make_lnprob_h, th_.ThetaLayoutH, "hier",
             LumFuncModelH),
}


@functools.lru_cache(maxsize=None)
def _catalog():
    """The 170,455-source catalog as a float64 JAX context and the port's
    float64 context on identical grids (fixed completeness: every family
    here takes it)."""
    cfg = LFConfig(min_comp_frac=0.5, quadrature="gauss", fix_comp=True)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=200_000,
                                              seed=7), cfg)
    _, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    return cfg, cat, jctx, context_from_arrays(arrays, "cpu", torch.float64)


def _close_pairs(layout, truth, seed, npairs=32):
    """``npairs`` thetas 0.001 box widths around the catalog's truth, then
    each moved by 6e-5 box widths (``chip_smoke.py``'s pairs)."""
    vals = {"Lstar": truth["Lstar"], "phistar": truth["phistar"],
            "sch_al": truth["sch_al"], "mu_L": truth["Lstar"], "sig_L": 0.3,
            "mu_p": truth["phistar"], "sig_p": 0.5}
    for k in (1, 2, 3):
        vals[f"L{k}"], vals[f"phi{k}"] = truth["Lstar"], truth["phistar"]
    center = np.array([vals[n.split("_")[0] if n.split("_")[0] in
                            ("Lstar", "phistar") else n]
                       for n in layout.names])
    width = np.asarray(layout.hi) - np.asarray(layout.lo)
    rng = np.random.default_rng(seed)
    base = center + 0.001 * width * rng.standard_normal((npairs,
                                                         center.size))
    return np.concatenate([base, base + 6e-5 * width
                           * rng.standard_normal(base.shape)])


def _dlnp_err(v, want):
    n = len(want) // 2
    return float(np.abs((v[n:] - v[:n]) - (want[n:] - want[:n])).max())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_float32_kernels_resolve_lnp_differences_past_the_crossing(family):
    """Through the value kernel and the value+gradient kernel's value
    column: the lnp-difference error against JAX's float64 lnprob <= 0.02
    at 170,455 sources (|lnL| ~ 2.5e6)."""
    cfg, cat, jctx, ctx = _catalog()
    jlayout_cls, jmake, layout_cls, model, _ = FAMILIES[family]
    jl = jlayout_cls.from_config(cfg)
    layout = layout_cls.from_config(PortConfig(
        min_comp_frac=0.5, quadrature="gauss", fix_comp=True))
    assert ctx.lum.shape[0] == 170_455
    th = _close_pairs(layout, cat["theta_true"], seed=7)
    want = np.asarray(jax.vmap(jmake(jctx, jl))(jnp.asarray(th)))
    data, (features, collapsed, _, value, vg) = cl._family(
        ctx, layout, model, torch.float32)
    t = torch.tensor(th)
    feats = features(t, data, layout, torch.float32)
    extra = 0.0 if collapsed is None else collapsed(feats, t)
    f32 = feats.float()
    assert data.g_a.dtype == torch.float32
    for part in (value(f32, data), vg(f32, data)[:, 0]):
        assert part.dtype == torch.float64
        err = _dlnp_err((part + extra).numpy(), want)
        assert err <= DLNP_TOL, (family, err)


@functools.lru_cache(maxsize=None)
def _past_the_crossing():
    """A ~34,000-source catalog, past ``FLOAT32_MAX_SOURCES``."""
    cfg = PortConfig(min_comp_frac=0.5, size_ln=9)
    cat = tsynth.apply_completeness_cut(
        tsynth.make_catalog(cfg, n_target=40_000, seed=7), cfg)
    assert len(cat["z"]) > cl.FLOAT32_MAX_SOURCES
    return cfg, cat


@pytest.mark.parametrize("family", ["free"] + list(FAMILIES))
def test_float32_run_past_the_crossing_is_refused(family):
    """A float32 model of each family past the crossing refuses its
    lnprob, the eager engine and the kernels' alike, and its NUTS
    gradient path, naming ``use_x64``; the float64 model (``use_x64``,
    the way out) takes the same engines."""
    cfg, cat = _past_the_crossing()
    cfg = cfg.replace(fix_comp=family != "free")
    cls = FAMILIES[family][4] if family != "free" else LumFuncModel
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"], device="cpu")
    for use_pallas in (False, True):
        c = cfg.replace(use_pallas=use_pallas)
        m32 = cls(c, dtype=torch.float32, **kw)
        for engine in (m32.lnprob_batch, m32._nuts_gradient_post):
            with pytest.raises(ValueError, match="use_x64"):
                engine()
        m64 = cls(c, dtype=torch.float64, **kw)
        assert m64.lnprob_batch().engine == ("plain" if use_pallas
                                             else "eager")
        assert callable(m64._nuts_gradient_post())


def test_float32_cli_run_past_the_crossing_names_the_config_way_out(
        tmp_path, monkeypatch, capsys):
    """``fitz`` on a float32 run of the ~34,000-source synthetic catalog
    stops before sampling, and its message names the ``--config`` file
    with ``use_x64``."""
    monkeypatch.chdir(tmp_path)
    cfg_path = tmp_path / "f32.json"
    cfg_path.write_text(json.dumps({"use_x64": False}))
    with pytest.raises(ValueError, match=r'--config file with \{"use_x64"'):
        port_main(["fitz", "--device", "cpu", "--synthetic", "40000",
                   "--seed", "7", "-mcf", "0.5", "--size-ln", "9",
                   "--config", str(cfg_path), "-nw", "16", "-ns", "20",
                   "-o", "t.dat"])
