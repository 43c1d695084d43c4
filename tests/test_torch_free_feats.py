"""The free-completeness feature kernel's wrapper (``free_feats``,
``csrc/free_feats.cu``) on the CPU: CPU tensors take its plain version,
its parameters are the kernel's struct field for field and put the
completeness crossing at ``fcmin``, it refuses what the kernel cannot
take, and every CPU route keeps the PyTorch map. The kernel against the
map: ``tests/test_torch_cuda.py``."""

import ctypes
import functools
import math
import pathlib
import re

import pytest
import torch

from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.models.context import build_context
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, in_box, sample_init)
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.ops.completeness import (
    _fleming_ratio_constants, fleming_from_logf)
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)


@functools.lru_cache(maxsize=None)
def _route(fcmin, fix_sch_al):
    """(layout, data, context) of a small free-completeness catalog."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11, fcmin=fcmin,
                   fix_sch_al=fix_sch_al)
    layout = ThetaLayout.from_config(cfg)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=120, seed=3),
                                 cfg)
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           field_id=cat["field_id"], dtype=torch.float64)
    return layout, cl.prepare_cuda_data(ctx, False, cfg.fcmin), ctx


def edge_thetas(layout, w, dtype, device="cpu", seed=0):
    """``w`` prior-box draws, the first seven rows (where ``w`` holds them)
    made to leave the box: Flim <= 0 and 0, NaN in Lstar and in a Flim,
    beyond ``hi`` in phistar and alpha_c, below ``lo`` in Lstar."""
    gen = torch.Generator(device=device).manual_seed(seed)
    th = sample_init(gen, layout, w, dtype=torch.float64, device=device)
    lo, hi = layout.lo, layout.hi
    k = 2 if layout.fix_sch_al else 3
    for row, col, v in ((0, k, -0.5), (1, 0, math.nan), (2, 1, hi[1] + 1.0),
                        (3, k + 1, 0.0), (4, layout.ndim - 1, 3 * hi[-1]),
                        (5, k + 2, math.nan), (6, 0, lo[0] - 1e-3)):
        if row < w:
            th[row, col] = v
    return th.to(dtype).contiguous()


def test_cpu_tensors_take_the_plain_version():
    """On a CPU route the spec holds no entry point, box or parameters,
    and ``free_feats`` returns its plain version's rows and flags without
    counting a launch (the kernel against the map: the card tests)."""
    layout, data, _ = _route(0.1, False)
    lo, hi = layout.bounds_arrays(torch.float64, "cpu")
    spec = cl.free_feats_spec(data, layout, lo, hi)
    assert spec.entry is None and spec.box is None and spec.params is None
    th = edge_thetas(layout, 50, torch.float32)
    feats, ok = cl.free_feats(th, spec)
    want, want_ok = cl.free_feats_reference(th, spec)
    assert feats.dtype == torch.float32 and ok.dtype == torch.bool
    assert feats.shape == (50, 6 + 2 * layout.nfields)
    torch.testing.assert_close(feats, want, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(ok, want_ok) and int((~ok).sum()) == 7
    assert cl.free_feats.launches == 0


def test_params_struct_is_the_kernels():
    """``_FreeFeatsParams`` is ``FreeFeatsParams`` of
    ``csrc/free_feats.cu`` field for field: the same names and C types in
    the same order (the launch hands the kernel a pointer to it)."""
    src = (pathlib.Path(cl.__file__).parents[1] / "csrc"
           / "free_feats.cu").read_text()
    body = re.search(r"struct FreeFeatsParams \{(.*?)\};", src, re.S)[1]
    fields = re.findall(r"^\s*(const double\*|double|int)\s+(\w+);", body,
                        re.M)
    ctype = {"const double*": ctypes.c_void_p, "double": ctypes.c_double,
             "int": ctypes.c_int}
    assert [(n, ctype[t]) for t, n in fields] == \
        cl._FreeFeatsParams._fields_


@pytest.mark.parametrize("fcmin", [0.05, 0.1, 0.5, 0.7, 0.95])
def test_fleming_ratio_constants_put_the_crossing_at_fcmin(fcmin):
    """The kernel's ``(sign, A)``: at ``log F50 + sign sqrt(A / alpha^2)``
    the unmodified Fleming curve reads ``fcmin``, for any alpha."""
    sign, a = _fleming_ratio_constants(fcmin)
    alpha = torch.tensor([0.7, 2.0, 3.5, 9.0], dtype=torch.float64)
    logf50 = torch.full_like(alpha, -16.7)
    fc = fleming_from_logf(logf50 + sign * torch.sqrt(a / alpha**2), logf50,
                           alpha, fcmin=0)
    torch.testing.assert_close(fc, torch.full_like(fc, fcmin), rtol=0,
                               atol=1e-12)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    from torch._subclasses.fake_tensor import FakeTensorMode
    layout, data, _ = _route(0.1, False)
    lo, hi = layout.bounds_arrays(torch.float64, "cpu")
    spec = cl.free_feats_spec(data, layout, lo, hi)
    d = layout.ndim
    with pytest.raises(TypeError, match="float32 or float64"):
        cl.free_feats(torch.zeros((4, d), dtype=torch.float16), spec)
    with pytest.raises(TypeError, match="float32 or float64"):
        cl.free_feats(torch.zeros((4, d), dtype=torch.int64), spec)
    for shape in ((4, d - 1), (4, d + 1), (d,)):
        with pytest.raises(ValueError, match=f"thetas must be \\(W, {d}\\)"):
            cl.free_feats(torch.zeros(shape), spec)
    for w in (0, cl.MAX_ROWS + 1):
        with pytest.raises(ValueError, match="launch range"):
            cl.free_feats(torch.zeros((w, d)), spec)
    with pytest.raises(ValueError, match="contiguous"):
        cl.free_feats(torch.zeros((d, 4)).T, spec)
    with FakeTensorMode(allow_non_fake_inputs=True):
        th = torch.zeros((4, d), device="cuda")
        with pytest.raises(ValueError, match="the route on cpu"):
            cl.free_feats(th, spec)
    assert cl.free_feats.launches == 0


def test_cpu_routes_keep_the_pytorch_map(monkeypatch):
    """On a CPU context neither the lnprob nor tempering's ``lnlike_fn``
    takes ``free_feats``; they give what they gave: the map's features, the
    plain value kernel and the box mask."""
    layout, data, ctx = _route(0.1, False)

    def refuse(*a):
        raise AssertionError("free_feats on a CPU route")

    monkeypatch.setattr(cl, "free_feats", refuse)
    th = edge_thetas(layout, 20, torch.float64, seed=1)
    lo, hi = layout.bounds_arrays(torch.float64, "cpu")
    lnl = cl.free_lnlike(cl._features(th, data, layout, torch.float64), data)
    ok = in_box(th, lo, hi)
    got = cl.make_cuda_lnprob(ctx, layout)(th)
    assert torch.equal(got, torch.where(ok, lnl, -math.inf))
    prior, like = cl.make_cuda_prior_like(ctx, layout)
    torch.testing.assert_close(like(th), lnl, rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(prior(th) == 0, ok)
