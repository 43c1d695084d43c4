"""The port's stage spans (``utils/tracing.py``): free when no profiler
records, and under one a tiny ``fit_model`` on the kernels' plain versions
records ``lf.step``, ``lf.lnprob``, ``lf.features``, ``lf.kernel`` and
``lf.post`` nested as the work is, without changing a bit of the chain."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.cli.main import main as port_main
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.utils import synth, tracing

NW, NS = 16, 10


@pytest.fixture(scope="module")
def model():
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11, nwalkers=NW, nsteps=NS,
                   use_pallas=True)
    cat = synth.apply_completeness_cut(
        synth.make_catalog(cfg, n_target=250, seed=11), cfg)
    return LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        device="cpu", dtype=torch.float64)


def _fit(model, profiled):
    gen = torch.Generator().manual_seed(7)
    if not profiled:
        model.fit_model(generator=gen)
        return None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.fit_model(generator=gen)
    return prof


def _spans(prof):
    """``{name: sorted [(start, end)]}`` of the ``lf.*`` events, in ns."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            s = e.start_ns()
            out.setdefault(e.name()[len(tracing.PREFIX):], []).append(
                (s, s + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _inside(kids, s, e):
    return [(a, b) for a, b in kids if s <= a and b <= e]


def test_span_without_profiler_is_the_shared_noop(monkeypatch):
    built = []

    def count(*a, **k):
        built.append(a)
        raise AssertionError("a span was built with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", count)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", count)
    for name in ("step", "lnprob", "features", "kernel", "post"):
        ctx = tracing.span(name)
        assert ctx is tracing._OFF
        with ctx:
            pass
    assert built == []


def test_span_under_profiler_records_one_host_event_and_no_op():
    """A span adds its own event and nothing else: no tensor, no copy,
    no sync, whatever the profiler is recording."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("probe"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names == ["lf.probe"]
    assert tracing.span("probe") is tracing._OFF


def test_fit_spans_nest_as_the_work(model):
    prof = _fit(model, profiled=True)
    sp = _spans(prof)
    assert set(sp) == {"step", "lnprob", "features", "kernel", "post"}
    steps, lnp = sp["step"], sp["lnprob"]
    assert len(steps) == NS
    assert len(lnp) == 2 * NS + 1
    # the starts' call comes before the first step, two calls a step
    assert lnp[0][1] <= steps[0][0]
    for s, e in steps:
        assert s < e
        assert len(_inside(lnp, s, e)) == 2
    for s, e in lnp:
        assert len(_inside(sp["features"], s, e)) == 1
        assert len(_inside(sp["kernel"], s, e)) == 1
    # every features and kernel span lies in some lnprob call
    assert len(sp["features"]) == len(sp["kernel"]) == len(lnp)
    (p0, p1), = sp["post"]
    assert steps[-1][1] <= p0 < p1


@pytest.mark.parametrize("route", ["prior_like", "value_and_grad"])
def test_other_lnprob_routes_have_the_three_spans(model, route):
    """``make_cuda_prior_like``'s ``lnlike_fn`` and the value+gradient
    lnprob share the body of the value lnprob, spans and all."""
    if route == "prior_like":
        fn = cl.make_cuda_prior_like(model.ctx, model.layout)[1]
    else:
        fn = cl.make_cuda_lnprob_and_grad(model.ctx, model.layout)
    th = torch.as_tensor(np.asarray(model.get_params())[None].repeat(4, 0),
                         dtype=torch.float64).requires_grad_(
                             route == "value_and_grad")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(th)
    sp = _spans(prof)
    assert [len(sp.get(k, [])) for k in ("lnprob", "features", "kernel")] \
        == [1, 1, 1]
    (s, e), = sp["lnprob"]
    assert _inside(sp["features"] + sp["kernel"], s, e) == sorted(
        sp["features"] + sp["kernel"])
    assert out.shape == (4,) and bool(torch.isfinite(out).all())


def test_chain_is_bit_for_bit_with_and_without_profiler(model):
    _fit(model, profiled=False)
    chain, samples = model.chain.copy(), model.samples.copy()
    _fit(model, profiled=True)
    np.testing.assert_array_equal(model.chain, chain)
    np.testing.assert_array_equal(model.samples, samples)


def test_profile_flag_trace_carries_the_spans(tmp_path, monkeypatch):
    """``fit --profile DIR``: the operator's trace holds the spans."""
    monkeypatch.chdir(tmp_path)
    od = dict(LFConfig().output_dict)
    od["triangle plot"] = False
    (tmp_path / "np.json").write_text(json.dumps({"output_dict": od}))
    assert port_main(["fit", "--device", "cpu", "--use-pallas",
                      "--synthetic", "300", "-mcf", "0.5", "--size-ln",
                      "11", "-ns", str(NS), "-nw", str(NW), "-o", "t.dat",
                      "--profile", "prof", "--config", "np.json"]) == 0
    trace = json.loads((tmp_path / "prof" / "fit_trace.json").read_text())
    got = Counter(e["name"] for e in trace["traceEvents"]
                  if str(e.get("name", "")).startswith(tracing.PREFIX))
    assert got == {"lf.step": NS, "lf.lnprob": 2 * NS + 1,
                   "lf.features": 2 * NS + 1, "lf.kernel": 2 * NS + 1,
                   "lf.post": 1}
