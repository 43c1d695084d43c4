"""The program under test for the luminosity-function configurations:
``lumfuncmcmc_tpu_torch``'s ``LumFuncModel`` (free or fixed completeness
over fields), built from a configuration's ``lfconfig`` block and a
catalog. A configuration names this file by its ``system`` key; a model
class with another constructor brings a file of its own beside it."""

from __future__ import annotations

import numpy as np
from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel


def load_library(device) -> str:
    """Loads the program's kernel library (building it at a checkout's
    first run) and says which of the two happened."""
    if device.type != "cuda":
        return "none (CPU)"
    from lumfuncmcmc_tpu_torch.ops import _build
    _build.load_library()
    return ("built in %.1f s" % _build.build_seconds
            if _build.build_seconds else "loaded from the cache")


def lf_config(cell, device: str):
    """The program's ``LFConfig``: the configuration's ``lfconfig`` with
    the mix's walkers and steps."""
    lf = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cell.config["lfconfig"].items()}
    for k in ("nwalkers", "nsteps"):
        if k in cell.traffic:
            lf[k] = int(cell.traffic[k])
    if device == "cpu":
        lf["use_pallas"] = True         # the kernels' plain versions
    return LFConfig(**lf)


def build(cell, catalog: dict, device: str):
    """The model of ``catalog`` on ``device``: context, grid and the
    per-source arrays."""
    return LumFuncModel(lf_config(cell, device), z=catalog["z"],
                        flux=catalog["flux"], flux_e=catalog["flux_e"],
                        field_id=catalog["field_id"], device=device)


def shapes(model) -> dict:
    """The shapes the kernels' counts take: grid cells, sources, fields."""
    return {"cells": int(np.prod(model.ctx.logL_grid.shape)),
            "sources": int(model.ctx.lum.shape[0]),
            "fields": len(model.cfg.Flim)}


def dtype(model) -> str:
    return str(model.dtype).replace("torch.", "")
