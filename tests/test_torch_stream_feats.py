"""The streaming route's feature kernel's wrapper (``stream_feats``,
``csrc/free_feats.cu``) on the CPU: CPU tensors take its plain version
(``_features_stream``, ``in_box``, ``_stream_collapsed``), its parameters
are the kernel's struct field for field, it refuses what the kernel cannot
take, and on a context that reads "cuda" the streaming value route takes it
once a call, while the value+gradient route and the resident route never
do. The kernel against the map: ``tests/test_torch_cuda.py``."""

import copy
import ctypes
import functools
import math
import pathlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.models.context import build_context
from lumfuncmcmc_tpu_torch.models.likelihood import ThetaLayout, in_box
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.utils import tracing
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)
from test_torch_free_feats import edge_thetas


@functools.lru_cache(maxsize=None)
def _case(fcmin=0.1, fix_sch_al=False):
    """(layout, context) of a small free-completeness catalog."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11, fcmin=fcmin,
                   fix_sch_al=fix_sch_al)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=200, seed=5),
                                 cfg)
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           field_id=cat["field_id"], dtype=torch.float64)
    return ThetaLayout.from_config(cfg), ctx


def _spec(fcmin=0.1, fix_sch_al=False):
    layout, ctx = _case(fcmin, fix_sch_al)
    data = cl.prepare_cuda_stream_data(ctx, fcmin, dtype=torch.float32)
    lo, hi = layout.bounds_arrays(torch.float64, "cpu")
    return layout, data, cl.stream_feats_spec(data, layout, lo, hi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fcmin,fix_sch_al", [(0.1, False), (0.0, False),
                                              (0.1, True)])
def test_cpu_tensors_take_the_plain_version(fcmin, fix_sch_al, dtype):
    """On a CPU route the spec holds no entry point, box or parameters, and
    ``stream_feats`` returns the PyTorch map's rows (rounded to float32),
    flags and shard 0's collapsed source terms of those same rows, without
    counting a launch."""
    layout, data, spec = _spec(fcmin, fix_sch_al)
    assert spec.entry is None and spec.box is None and spec.params is None
    th = edge_thetas(layout, 50, dtype, seed=3)
    n0 = cl.stream_feats.launches
    feats, ok, coll = cl.stream_feats(th, spec)
    assert cl.stream_feats.launches == n0
    rows = cl._features_stream(th, data, layout, torch.float32)
    assert feats.dtype == torch.float32 and ok.dtype == torch.bool
    assert coll.dtype == torch.float64 and coll.shape == (50,)
    assert feats.shape == (50, 6 + 2 * layout.nfields)
    torch.testing.assert_close(feats, rows.float(), rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(ok, in_box(th, spec.lo, spec.hi))
    assert int((~ok).sum()) == 7
    # the collapse reads the rows as the value kernel does: float32,
    # promoted
    torch.testing.assert_close(
        coll, cl._stream_collapsed(feats.double(), data), rtol=0, atol=0,
        equal_nan=True)
    assert torch.isfinite(coll[ok]).all()


def test_params_struct_is_the_kernels():
    """``_StreamFeatsParams`` is ``StreamFeatsParams`` of
    ``csrc/free_feats.cu`` field for field: the same names and C types in
    the same order (the launch hands the kernel a pointer to it)."""
    src = (pathlib.Path(cl.__file__).parents[1] / "csrc"
           / "free_feats.cu").read_text()
    body = re.search(r"struct StreamFeatsParams \{(.*?)\};", src, re.S)[1]
    fields = re.findall(r"^\s*(const double\*|double|int)\s+(\w+);", body,
                        re.M)
    ctype = {"const double*": ctypes.c_void_p, "double": ctypes.c_double,
             "int": ctypes.c_int}
    assert [(n, ctype[t]) for t, n in fields] == \
        cl._StreamFeatsParams._fields_
    assert len(fields) == 10


def test_wrapper_rejects_what_the_kernel_cannot_take():
    from torch._subclasses.fake_tensor import FakeTensorMode
    layout, _, spec = _spec()
    d = layout.ndim
    for dt in (torch.float16, torch.int64):
        with pytest.raises(TypeError,
                           match="stream_feats takes float32 or float64"):
            cl.stream_feats(torch.zeros((4, d), dtype=dt), spec)
    for shape in ((4, d - 1), (4, d + 1), (d,)):
        with pytest.raises(ValueError, match=f"thetas must be \\(W, {d}\\)"):
            cl.stream_feats(torch.zeros(shape), spec)
    for w in (0, cl.MAX_ROWS + 1):
        with pytest.raises(ValueError, match="launch range"):
            cl.stream_feats(torch.zeros((w, d)), spec)
    with pytest.raises(ValueError, match="contiguous"):
        cl.stream_feats(torch.zeros((d, 4)).T, spec)
    with FakeTensorMode(allow_non_fake_inputs=True):
        th = torch.zeros((4, d), device="cuda")
        with pytest.raises(ValueError, match="the route on cpu"):
            cl.stream_feats(th, spec)
    assert cl.stream_feats.launches == 0


def _on_card(ctx):
    """``ctx`` with luminosities on a device that reads "cuda"."""
    ctx = copy.copy(ctx)

    class _Lum:
        shape = ctx.lum.shape
        device = torch.device("cuda")

    object.__setattr__(ctx, "lum", _Lum())
    return ctx


def _spans(fn, th):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(th)
    return out, [e.name() for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(tracing.PREFIX)]


@pytest.fixture
def calls(monkeypatch):
    """Every ``stream_feats`` call, recorded (it still runs)."""
    seen, real = [], cl.stream_feats

    def counted(thetas, spec):
        seen.append(thetas.shape[0])
        return real(thetas, spec)

    monkeypatch.setattr(cl, "stream_feats", counted)
    return seen


def test_streaming_value_route_takes_the_kernel_once_a_call(monkeypatch,
                                                            calls):
    """On the card the streaming value path is ``stream_feats``, the value
    kernel, then their sum: here the plain versions run, the route itself
    ``_likelihood``'s with the context taken for a card's. One call a
    lnprob call; ``lf.features``, ``lf.kernel`` and ``lf.collapse`` once
    each; the values the PyTorch map's pieces give, -inf outside the box
    through the caller's mask."""
    layout, ctx = _case()
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    engine = cl._engine(ctx, layout, "single")
    data = engine[3]
    assert isinstance(data, cl.CudaStreamData)
    lnlike = cl._likelihood(_on_card(ctx), layout, engine, grad=False,
                            flags=True)
    th = edge_thetas(layout, 12, torch.float64, seed=8)
    for n in (1, 2):
        (lnl, ok), names = _spans(lnlike, th)
        assert calls == [12] * n
        assert names.count("lf.features") == names.count("lf.kernel") \
            == names.count("lf.collapse") == 1
    rows = cl._features_stream(th, data, layout, torch.float32)
    want = (cl.free_stream_lnlike(rows.float(), data)
            + cl._stream_collapsed(rows, data))
    assert torch.equal(ok, in_box(th, *layout.bounds_arrays(torch.float64,
                                                            "cpu")))
    torch.testing.assert_close(lnl[ok], want[ok], rtol=0, atol=0)
    masked = torch.where(ok, lnl, -math.inf)
    assert torch.isneginf(masked[~ok]).all() and int((~ok).sum()) == 7


@pytest.mark.parametrize("route", ["value_and_grad", "resident"])
def test_other_routes_never_take_the_kernel(monkeypatch, calls, route):
    """The streaming value+gradient route (NUTS: autograd through the
    PyTorch map) and the resident route (``free_feats``) on a context that
    reads "cuda" never call ``stream_feats``."""
    layout, ctx = _case()
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES",
                        0 if route == "value_and_grad" else 10 ** 9)
    engine = cl._engine(ctx, layout, "single")
    lnlike = cl._likelihood(_on_card(ctx), layout, engine,
                            grad=route == "value_and_grad", flags=True)
    th = edge_thetas(layout, 12, torch.float64, seed=9)
    if route == "value_and_grad":
        th.requires_grad_(True)
    (lnl, _), names = _spans(lnlike, th)
    if route == "value_and_grad":
        lnl.sum().backward()
        assert names.count("lf.collapse") == 1
    else:
        assert "lf.collapse" not in names
    assert calls == []
