"""The plain reference agrees with the port's float64 eager engine on
small catalogs: values and gradients, trapezoid and Gauss-Legendre grids.
The reference imports nothing of the port; this test alone sets the two
side by side."""

import json
import os

import numpy as np
import pytest
import torch

from portbench.tests.tiny import REPO
from portbench.catalogs.poisson_fields import make as make_catalog
from portbench.reference.lf import Reference


def _config(name, n, size, quadrature=None):
    with open(os.path.join(REPO, "portbench", "configs",
                           name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["catalog"]["n_target"] = n
    cfg["lfconfig"]["size_ln"] = size
    if quadrature:
        cfg["lfconfig"]["quadrature"] = quadrature
    return cfg


def _center(cfg):
    """A theta near the catalog's truth: the configuration's Schechter
    and completeness values, phi* raised to the catalog's amplitude."""
    lf = cfg["lfconfig"]
    return np.array([lf["Lstar"], lf["phistar"] - 1.0, lf["sch_al"]]
                    + lf["Flim"] + [lf["alpha"]])


@pytest.mark.parametrize("quadrature,n,size", [("trapz", 600, 31),
                                               ("gauss", 3000, 16)])
def test_reference_matches_port_eager(quadrature, n, size):
    from lumfuncmcmc_tpu_torch.config import LFConfig
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
    cfg = _config("flagship", n, size, quadrature)
    cat = make_catalog(cfg, 2 ** 33 + 5)
    lf = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["lfconfig"].items()}
    model = LumFuncModel(LFConfig(**lf), z=cat["z"], flux=cat["flux"],
                         flux_e=cat["flux_e"], field_id=cat["field_id"],
                         device="cpu", dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    th = (0.7 * torch.as_tensor(_center(cfg))
          + 0.3 * model._initial_positions(gen)[:12])
    th.requires_grad_(True)
    port = model._make_scalar_lnprob()(th)
    (g_port,) = torch.autograd.grad(port.sum(), th)
    ref = Reference(cfg, cat["z"], cat["flux"], cat["field_id"])
    v_ref, g_ref = ref.value_and_grad(th.detach().numpy())
    port = port.detach().numpy()
    # the port interpolates a 32,768-node distance table where the
    # reference integrates: ~1e-10 dex a source
    np.testing.assert_allclose(port, v_ref, rtol=1e-9)
    np.testing.assert_allclose(g_port.numpy(), g_ref, rtol=1e-6,
                               atol=1e-6 * np.abs(g_ref).max())


def test_reference_box_and_dtype():
    cfg = _config("flagship", 300, 11)
    cat = make_catalog(cfg, 1)
    ref = Reference(cfg, cat["z"], cat["flux"], cat["field_id"])
    th = np.tile(_center(cfg), (3, 1))
    th[1, 0] = 46.0                     # outside the L* box
    v64 = ref.lnprob_fn()(torch.as_tensor(th)).numpy()
    assert np.isfinite(v64[0]) and v64[1] == -np.inf
    v32 = ref.lnprob_fn(torch.float32)(torch.as_tensor(th)).numpy()
    assert v32.dtype == np.float32 and abs(v32[0] - v64[0]) < 1.0


def test_catalog_sizes_do_not_depend_on_seed():
    cfg = _config("flagship", 2000, 101)
    a, b = make_catalog(cfg, 7), make_catalog(cfg, 2 ** 31 + 9)
    assert np.array_equal(np.bincount(a["field_id"]),
                          np.bincount(b["field_id"]))
    assert not np.array_equal(a["z"], b["z"])
    again = make_catalog(cfg, 7)
    assert np.array_equal(a["flux"], again["flux"])
