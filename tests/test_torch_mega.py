"""The HETDEX-scale deployment ``mega`` (``portbench/configs/mega.json``)
on the CPU: a ``survey_fields`` catalog of the survey's own two fields,
their areas cut by ``area_scale`` to ~51,500 sources, just past
``STREAM_MIN_SOURCES``, on an 11 x 11 grid a field, so the port takes the
plain versions of the streaming kernels in float64.

- the port's float64 lnprob equals the plain reference
  (``portbench/reference/lf.py``) to 1e-9 relative, inside the prior box
  and -inf outside it: the port interpolates a 32,768-node distance table
  where the reference integrates (~1e-10 dex a source), the rest is the
  same sums in another order;
- a float32 model refuses the catalog;
- the streaming route opens ``lf.collapse`` once a call, the resident
  route never;
- the catalog's size is the survey's: the same in every seed, each
  field's count the intensity integral over its area above its root.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.utils import tracing
from portbench.catalogs import survey_fields
from portbench.reference.lf import (
    LOG10_4PI, SQARCSEC_PER_SR, Cosmology, Reference, completeness_root,
    fleming)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AREA_SCALE = 0.075
SIZE_LN = 11
SEED = 2 ** 31 + 22


@functools.lru_cache(maxsize=None)
def _config_json():
    with open(os.path.join(REPO, "portbench", "configs", "mega.json")) as fh:
        cfg = json.load(fh)
    cfg["catalog"]["area_scale"] = AREA_SCALE
    cfg["lfconfig"]["size_ln"] = SIZE_LN
    return json.dumps(cfg)


def _config():
    return json.loads(_config_json())


@functools.lru_cache(maxsize=None)
def _catalog(seed=SEED):
    return survey_fields.make(_config(), seed)


def _lf_config(cfg, **over):
    lf = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["lfconfig"].items()}
    lf.update(use_pallas=True, nwalkers=8, nsteps=4)
    lf.update(over)
    return LFConfig(**lf)


def _model(cfg, dtype=torch.float64, **over):
    cat = _catalog()
    return LumFuncModel(_lf_config(cfg, **over), z=cat["z"],
                        flux=cat["flux"], flux_e=cat["flux_e"],
                        field_id=cat["field_id"], device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def model():
    return _model(_config())


def _thetas(cfg, n=8, seed=5):
    """``n`` thetas about the catalog's truth; rows 1 and 4 leave the
    prior box (L* above its upper edge, one Flim below its lower)."""
    lf = cfg["lfconfig"]
    truth = np.array([lf["Lstar"], lf["phistar"], lf["sch_al"]]
                     + lf["Flim"] + [lf["alpha"]])
    rng = np.random.default_rng(seed)
    th = truth + rng.normal(0.0, 1.0, (n, truth.size)) * np.array(
        [0.03, 0.03, 0.02] + [0.2] * len(lf["Flim"]) + [0.2])
    th[1, 0] = lf["Lstar_lims"][1] + 0.1
    th[4, 3] = lf["Flim_lims"][0] - 0.5
    return th


def test_the_catalog_takes_the_streaming_route(model):
    n = int(model.ctx.lum.shape[0])
    assert 45_000 <= n <= 60_000
    assert n >= cl.STREAM_MIN_SOURCES and n >= cl.FLOAT32_MAX_SOURCES
    assert model.lnprob_batch().engine == "plain-stream"
    assert model.dtype == torch.float64


def test_port_lnprob_matches_the_reference(model):
    cfg = _config()
    cat = _catalog()
    th = _thetas(cfg)
    port = model.lnprob_batch()(torch.as_tensor(th)).numpy()
    ref = Reference(cfg, cat["z"], cat["flux"], cat["field_id"])
    want = ref.lnprob_fn()(torch.as_tensor(th)).numpy()
    out = np.zeros(len(th), dtype=bool)
    out[[1, 4]] = True
    assert np.all(np.isneginf(port[out])) and np.all(np.isneginf(want[out]))
    assert np.all(np.isfinite(port[~out]))
    # |lnp| ~ 1e6 here: 1e-9 relative is ~1e-3, within the 0.05 an accept
    # step bears
    assert np.abs(port[~out]).min() > 1e5
    np.testing.assert_allclose(port[~out], want[~out], rtol=1e-9)
    # lnp differences of close thetas, what the accept step reads
    d_port = port[~out][1:] - port[~out][0]
    d_want = want[~out][1:] - want[~out][0]
    np.testing.assert_allclose(d_port, d_want, rtol=0, atol=1e-3)


def test_float32_model_refuses_the_catalog():
    m = _model(_config(), dtype=torch.float32, use_x64=False)
    with pytest.raises(ValueError, match="use_x64"):
        m.lnprob_batch()


def _collapse_spans(fn, th):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(th)
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tracing.PREFIX)]


def test_collapse_span_opens_once_a_call_on_the_streaming_route(model):
    th = torch.as_tensor(_thetas(_config(), n=6))
    names = _collapse_spans(model.lnprob_batch(), th)
    assert names.count("lf.collapse") == 1
    assert names.count("lf.lnprob") == 1


def test_resident_route_opens_no_collapse_span(model, monkeypatch):
    """The same catalog under a raised gate takes the resident free
    kernel, whose value is the whole lnlike: no collapsed terms, no
    span."""
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES",
                        int(model.ctx.lum.shape[0]) + 1)
    fn = cl.make_cuda_lnprob(model.ctx, model.layout)
    assert fn.engine == "plain"
    names = _collapse_spans(fn, torch.as_tensor(_thetas(_config(), n=6)))
    assert "lf.collapse" not in names and names.count("lf.kernel") == 1


def test_free_feats_path_opens_no_collapse_span(model, monkeypatch):
    """On the card the resident value path is ``free_feats`` then the
    value kernel: the card's route (``feature_kernels``) on their plain
    versions here, ``free_feats`` patched before the route binds it."""
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES",
                        int(model.ctx.lum.shape[0]) + 1)
    seen = []

    def feats(thetas, spec):
        seen.append("feats")
        return cl.free_feats_reference(thetas, spec)

    monkeypatch.setattr(cl, "free_feats", feats)
    route = cl._route(model.ctx, model.layout, "single", grad=False,
                      feature_kernels=True)
    lnlike = cl._likelihood(route, flags=True)
    th = torch.as_tensor(_thetas(_config(), n=6))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lnlike(th)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(tracing.PREFIX)]
    assert seen == ["feats"]
    assert "lf.collapse" not in names
    assert names.count("lf.features") == names.count("lf.kernel") == 1


def test_catalog_size_is_the_surveys_in_every_seed():
    cfg = _config()
    counts = [np.bincount(survey_fields.make(cfg, s)["field_id"])
              for s in (SEED, 7, 2 ** 40 + 3)]
    assert all(np.array_equal(c, counts[0]) for c in counts)
    assert np.array_equal(counts[0], survey_fields.expected_counts(cfg))
    assert not np.array_equal(_catalog(SEED)["z"][:100],
                              survey_fields.make(cfg, 7)["z"][:100])
    np.testing.assert_allclose(counts[0], _intensity_integral(cfg),
                               rtol=5e-3)


def _intensity_integral(cfg):
    """Each field's expected sources above its completeness root, by a
    quadrature of its own: trapezoid in z over 801 nodes, and in log L
    from the root's luminosity at each z, over 801 nodes, of phi(L)
    dV/dz Omega_f(L, z)."""
    lf, cat = cfg["lfconfig"], cfg["catalog"]
    cosmo = Cosmology(cfg["cosmology"])
    z = np.linspace(cat["zmin"], cat["zmax"], 801)
    ldl = cosmo.log10_dl_cm(z)
    logf50 = np.log10(np.asarray(lf["Flim"])) - 17.0
    roots = completeness_root(logf50, lf["alpha"], lf["min_comp_frac"],
                              lf["fcmin"])
    u = np.linspace(0.0, 1.0, 801)[:, None]
    out = []
    for f, root in enumerate(roots):
        lo = root + LOG10_4PI + 2.0 * ldl
        hi = lf["Lh"] - 1.0
        logl = lo + u * (hi - lo)
        x = logl - lf["Lstar"]
        phi = (np.log(10.0) * 10.0 ** lf["phistar"]
               * 10.0 ** (x * (lf["sch_al"] + 1.0)) * np.exp(-(10.0 ** x)))
        om = (cat["area_scale"] * lf["Omega_0"][f] / SQARCSEC_PER_SR
              * fleming(logl - LOG10_4PI - 2.0 * ldl, logf50[f],
                        lf["alpha"], lf["fcmin"]))
        in_l = np.trapezoid(phi * om, logl, axis=0)
        out.append(np.trapezoid(in_l * cosmo.dvdz_sr(z), z))
    return np.array(out)
