"""The streaming route's feature kernel's wrapper (``stream_feats``,
``csrc/free_feats.cu``) on the CPU: CPU tensors take its plain version
(``_features_stream``, ``in_box``, ``_stream_collapsed``), its parameters
are the kernel's struct field for field, it refuses what the kernel cannot
take, and on the card's routes (``_route``'s ``feature_kernels``) the
streaming value route takes it once a call, while every other route never
does and takes its own feature stage. The kernel against the map:
``tests/test_torch_cuda.py``."""

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
from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH
from lumfuncmcmc_tpu_torch.models.likelihood import ThetaLayout, in_box
from lumfuncmcmc_tpu_torch.models.likelihood_z import ThetaLayoutZ
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


@functools.lru_cache(maxsize=None)
def _family_case(family):
    """(model, layout, context) of a small catalog of ``family``: "free"
    (:func:`_case`), or "fixed", "z" or "hier" under fixed
    completeness."""
    if family == "free":
        return ("single",) + _case()
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11, fix_comp=True)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=200, seed=5),
                                 cfg)
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           field_id=cat["field_id"], dtype=torch.float64)
    cls = {"fixed": ThetaLayout, "z": ThetaLayoutZ, "hier": ThetaLayoutH}
    return ({"fixed": "single"}.get(family, family),
            cls[family].from_config(cfg), ctx)


def _spans(fn, th):
    """``fn(th)`` and the ``lf.*`` spans it opened, in the order they
    opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(th)
    events = sorted((e.start_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(tracing.PREFIX))
    return out, [name for _, name in events]


@pytest.fixture
def calls(monkeypatch):
    """Every ``stream_feats`` call, recorded (it still runs); patched
    before a route binds it."""
    seen, real = [], cl.stream_feats

    def counted(thetas, spec):
        seen.append(thetas.shape[0])
        return real(thetas, spec)

    monkeypatch.setattr(cl, "stream_feats", counted)
    return seen


def test_streaming_value_route_takes_the_kernel_once_a_call(monkeypatch,
                                                            calls):
    """On the card the streaming value route is ``stream_feats``, the
    value kernel, then their sum: here the card's route
    (``feature_kernels``) on the plain versions. One call a lnprob call;
    ``lf.lnprob``, ``lf.features``, ``lf.kernel`` and ``lf.collapse`` once
    each, in that order (``mega.stretch``'s route); the values the
    PyTorch map's pieces give, -inf outside the box through the mask."""
    layout, ctx = _case()
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    route = cl._route(ctx, layout, "single", grad=False,
                      feature_kernels=True)
    data = route.data
    assert isinstance(data, cl.CudaStreamData)
    assert route.engine == "plain-stream"
    lnlike = cl._likelihood(route, flags=True)
    th = edge_thetas(layout, 12, torch.float64, seed=8)
    for n in (1, 2):
        (lnl, ok), names = _spans(lnlike, th)
        assert calls == [12] * n
        assert names == ["lf.features", "lf.kernel", "lf.collapse"]
    rows = cl._features_stream(th, data, layout, torch.float32)
    want = (cl.free_stream_lnlike(rows.float(), data)
            + cl._stream_collapsed(rows, data))
    assert torch.equal(ok, in_box(th, *layout.bounds_arrays(torch.float64,
                                                            "cpu")))
    torch.testing.assert_close(lnl[ok], want[ok], rtol=0, atol=0)
    got, names = _spans(cl._lnprob(route), th)
    assert names == ["lf.lnprob", "lf.features", "lf.kernel", "lf.collapse"]
    assert torch.isneginf(got[~ok]).all() and int((~ok).sum()) == 7
    torch.testing.assert_close(got[ok], want[ok], rtol=0, atol=0)


# route: family, streaming gate, value+gradient, source shards, the feature
# stage the route takes, whether it collapses
OTHER_ROUTES = {
    "value_and_grad": ("free", 0, True, 1, "_features_stream", True),
    "resident": ("free", 10 ** 9, False, 1, "free_feats", False),
    "resident_vg": ("free", 10 ** 9, True, 1, "_features", False),
    "stream_grid": ("free", 0, False, 2, "_features_stream", True),
    "fixed": ("fixed", 0, False, 1, "_features", True),
    "fixed_vg": ("fixed", 0, True, 1, "_features", True),
    "z": ("z", 0, False, 1, "_features_z", False),
    "z_vg": ("z", 0, True, 1, "_features_z", False),
    "hier": ("hier", 0, False, 1, "_features_hier", True),
    "hier_vg": ("hier", 0, True, 1, "_features_hier", True),
}


@pytest.mark.parametrize("route", list(OTHER_ROUTES))
def test_other_routes_never_take_the_kernel(monkeypatch, calls, route):
    """Every route of the card but the streaming value route of one shard
    (the value+gradient routes, a source-split grid's, the resident free
    route, fixed completeness, the z and hierarchical models) never calls
    ``stream_feats``: each takes its own feature stage (``free_feats`` on
    the resident free value route, ``flagship.stretch``'s, else the
    PyTorch map of its family) and opens ``lf.lnprob``, ``lf.features``,
    ``lf.kernel``, then ``lf.collapse`` only where the family collapses."""
    family, gate, grad, nshards, stage, collapses = OTHER_ROUTES[route]
    model, layout, ctx = _family_case(family)
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", gate)
    seen = []
    for name in ("free_feats", "_features", "_features_stream",
                 "_features_z", "_features_hier"):
        def entered(*a, _name=name, _real=getattr(cl, name)):
            seen.append(_name)
            return _real(*a)

        monkeypatch.setattr(cl, name, entered)
    r = cl._route(ctx, layout, model, grad=grad, nshards=nshards,
                  shard=0 if nshards > 1 else None, feature_kernels=True)
    assert (r.collapse is not None) == collapses
    lo, hi = layout.bounds_arrays(torch.float64, "cpu")
    gen = torch.Generator().manual_seed(9)
    th = lo + (hi - lo) * torch.rand((12, layout.ndim), generator=gen,
                                     dtype=torch.float64)
    th.requires_grad_(grad)
    lnp, names = _spans(cl._lnprob(r), th)
    if grad:
        lnp.sum().backward()
        assert torch.isfinite(th.grad).all()
    assert seen[0] == stage
    assert names == ["lf.lnprob", "lf.features", "lf.kernel"] + (
        ["lf.collapse"] if collapses else [])
    assert calls == []
