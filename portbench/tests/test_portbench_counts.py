"""The roofline's operations and bytes depend on the kernel family and
the shapes alone: two data layouts of the same catalog give the same
counts, and the counts are ``chip_smoke.py _bound``'s without the
streaming run table and padding. The peaks are the published ones."""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest
import torch

from portbench.tests.tiny import REPO
from portbench.catalogs.poisson_fields import make as make_catalog
from portbench.harness.cells import load_module

COUNTS = load_module(os.path.join(REPO, "portbench", "counts", "free.py"))
KERNELS = ("free_lnlike", "free_lnlike_vg", "free_stream_lnlike",
           "free_stream_lnlike_vg")


def _shapes(data, stream):
    """(cells, valid sources, fields) of a program's kernel data."""
    valid = (data.s_mask[0] > 0) if stream else (data.s_mask > 0)
    return int(data.g_a.numel()), int(valid.sum()), int(data.nfields)


@pytest.fixture(scope="module")
def layouts():
    from lumfuncmcmc_tpu_torch.config import LFConfig
    from lumfuncmcmc_tpu_torch.models.context import build_context
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    with open(os.path.join(REPO, "portbench", "configs",
                           "flagship.json")) as fh:
        cfg = json.load(fh)
    cfg["catalog"]["n_target"] = 4000
    cfg["lfconfig"]["size_ln"] = 21
    cat = make_catalog(cfg, 99)
    lf = LFConfig(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in cfg["lfconfig"].items()})
    _, ctx = build_context(lf, z=cat["z"], flux=cat["flux"],
                           field_id=cat["field_id"], device="cpu",
                           dtype=torch.float32)
    resident = cl.prepare_cuda_data(ctx, False, lf.fcmin,
                                    dtype=torch.float32)
    stream = cl.prepare_cuda_stream_data(ctx, lf.fcmin, nshards=1,
                                         dtype=torch.float32)
    return resident, stream


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("rows", [1, 8, 50])
def test_counts_follow_shapes_not_layout(layouts, kernel, rows):
    resident, stream = layouts
    a = COUNTS.counts(kernel, rows, *_shapes(resident, False))
    b = COUNTS.counts(kernel, rows, *_shapes(stream, True))
    assert a == b
    assert stream.s_logf.shape[1] > _shapes(stream, True)[1]  # padded


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_counts", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("rows", [8, 50])
def test_counts_match_chip_smoke_bound(kernel, rows):
    cs = _chip_smoke()
    cells, srcs, nf = 51005, 1700, 5
    stream = "stream" in kernel
    mask = torch.ones((1, srcs) if stream else (srcs,))
    data = SimpleNamespace(
        g_a=torch.zeros(cells), s_a=torch.zeros(srcs), s_mask=mask,
        s_logf=torch.zeros(1, srcs), nfields=nf,
        runs=torch.zeros(0, dtype=torch.int32))
    _, _, nbytes, ops, _ = cs._bound(kernel, data, rows)
    assert COUNTS.counts(kernel, rows, cells, srcs, nf) == (ops, nbytes)
    peaks = json.load(open(os.path.join(REPO, "portbench", "peaks.json")))
    assert (peaks["float32_ops_per_s"], peaks["hbm_bytes_per_s"]) == (
        cs.PEAK_F32_OPS, cs.PEAK_BYTES) == (67e12, 3.35e12)
