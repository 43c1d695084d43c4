"""Card-only tests of the PyTorch port (marker ``cuda``; they skip on a
machine without a CUDA device). No jax here: the machine with the card
runs them without the JAX package's dependencies:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.models.context import build_context
from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, in_box, sample_init)
from lumfuncmcmc_tpu_torch.models.likelihood_z import ThetaLayoutZ
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.samplers import nuts
from lumfuncmcmc_tpu_torch.samplers.affine import run_stretch
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _context(cfg, device, dtype=torch.float32):
    cat = apply_completeness_cut(make_catalog(cfg, n_target=400, seed=3),
                                 cfg)
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           field_id=cat["field_id"], device=device,
                           dtype=dtype)
    return ctx


@pytest.mark.parametrize("fix_comp", [False, True])
@pytest.mark.parametrize("w", [1, 13, 64])
def test_kernel_matches_plain_version(device, fix_comp, w):
    """Each kernel equals its plain version in float32 on the card
    (rtol 1e-4: float32 sums of the same terms in another order)."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=41, fix_comp=fix_comp)
    layout = ThetaLayout.from_config(cfg)
    ctx = _context(cfg, device)
    data = cl.prepare_cuda_data(ctx, fix_comp, cfg.fcmin)
    gen = torch.Generator(device=device).manual_seed(w)
    feats = cl._features(sample_init(gen, layout, w, dtype=torch.float32,
                                     device=device), data, layout,
                         torch.float32).float()
    before = (cl.free_lnlike.launches, cl.fixed_lnlike.launches)
    if fix_comp:
        got = cl.fixed_lnlike(feats, data)
        ref = cl.fixed_lnlike_reference(feats, data)
    else:
        got = cl.free_lnlike(feats, data)
        ref = cl.free_lnlike_reference(feats, data)
    after = (cl.free_lnlike.launches, cl.fixed_lnlike.launches)
    assert after[int(fix_comp)] == before[int(fix_comp)] + 1
    assert after[1 - int(fix_comp)] == before[1 - int(fix_comp)]
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4)


def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(device):
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11)
    ctx = _context(cfg, device)
    data = cl.prepare_cuda_data(ctx, False, cfg.fcmin)
    with pytest.raises(TypeError, match="float32"):
        cl.free_lnlike(torch.zeros((4, 16), device=device,
                                   dtype=torch.float64), data)
    with pytest.raises(ValueError, match="features must be"):
        cl.free_lnlike(torch.zeros((4, 15), device=device), data)
    cpu_data = cl.prepare_cuda_data(_context(cfg, "cpu"), False, cfg.fcmin)
    with pytest.raises(ValueError, match="grid data on cpu"):
        cl.free_lnlike(torch.zeros((4, 16), device=device), cpu_data)


def test_step_loop_never_synchronises_with_the_host(device):
    """The whole sampler run, kernel launches included, under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=21)
    layout = ThetaLayout.from_config(cfg)
    ctx = _context(cfg, device)
    lnprob = cl.make_cuda_lnprob(ctx, layout)
    gen = torch.Generator(device=device).manual_seed(0)
    pos0 = sample_init(gen, layout, 32, dtype=torch.float32, device=device)
    lnprob(pos0)                    # builds and loads the kernels
    torch.cuda.synchronize()
    n0, f0 = cl.free_lnlike.launches, cl.free_feats.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, chain, lnps, acc = run_stretch(lnprob, pos0, gen, 25,
                                              move="mix")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cl.free_lnlike.launches - n0 == 1 + 2 * 25
    assert cl.free_feats.launches - f0 == 1 + 2 * 25
    assert chain.shape == (25, 32, layout.ndim)
    assert torch.isfinite(lnps[-1]).all()
    assert 0 < float(acc.sum()) < 25 * 32


def _ulps(a, b):
    """float32 ``a`` against ``b``: units in the last place apart (0 where
    both are NaN), and whether each entry is the same number."""
    both_nan = a.isnan() & b.isnan()
    ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return ulps.masked_fill(both_nan, 0), (a == b) | both_nan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fix_sch_al", [False, True])
@pytest.mark.parametrize("fcmin", [0.1, 0.0])
def test_free_feats_kernel_matches_the_pytorch_map(device, fcmin, fix_sch_al,
                                                   dtype):
    """``free_feats`` on the card against the PyTorch map it replaces, run
    on the card (``_features`` rounded to float32, ``in_box``), at W = 1,
    50 and 257 with rows out of the box (Flim <= 0, NaN, beyond ``hi``):
    every feature within 1 float32 ulp, >= 99.9% of them the same number,
    NaN where the map gives NaN, the flags equal; one launch a call."""
    from test_torch_free_feats import edge_thetas
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11, fcmin=fcmin,
                   fix_sch_al=fix_sch_al)
    layout = ThetaLayout.from_config(cfg)
    data = cl.prepare_cuda_data(_context(cfg, device), False, cfg.fcmin)
    lo, hi = layout.bounds_arrays(torch.float32, device)
    spec = cl.free_feats_spec(data, layout, lo, hi)
    for w in (1, 50, 257):
        th = edge_thetas(layout, w, dtype, device, seed=w)
        n0 = cl.free_feats.launches
        feats, ok = cl.free_feats(th, spec)
        assert cl.free_feats.launches == n0 + 1
        want = cl._features(th, data, layout, torch.float32).float()
        assert feats.shape == want.shape and feats.dtype == torch.float32
        assert torch.equal(feats.isnan(), want.isnan())
        ulps, same = _ulps(feats, want)
        assert int(ulps.max()) <= 1
        assert float(same.float().mean()) >= 0.999
        assert torch.equal(ok, in_box(th, lo, hi))
        assert int((~ok).sum()) == min(w, 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_value_path_at_the_flagship_config_is_the_pytorch_maps(device,
                                                               dtype):
    """The flagship's configuration (the default fields, free completeness,
    trapz-101): ``make_cuda_lnprob`` through ``free_feats`` gives the
    values of the PyTorch map's route (``_features``, ``free_lnlike``) to
    the kernels' rtol 1e-4 inside the box and -inf outside it;
    tempering's ``lnlike_fn`` gives the unmasked values; a call makes at
    most 4 device launches (feature kernel, value kernel, cast, mask)."""
    from torch.profiler import ProfilerActivity, profile

    from test_torch_free_feats import edge_thetas
    cfg = LFConfig(min_comp_frac=0.5, size_ln=101)
    layout = ThetaLayout.from_config(cfg)
    ctx = _context(cfg, device)
    lnprob = cl.make_cuda_lnprob(ctx, layout)
    _, like = cl.make_cuda_prior_like(ctx, layout)
    lo, hi = layout.bounds_arrays(torch.float32, device)
    for w in (50, 257):
        th = edge_thetas(layout, w, dtype, device, seed=w)
        lnl = cl.free_lnlike(cl._features(th, lnprob.data, layout,
                                          torch.float32).float(),
                             lnprob.data).to(dtype)
        ok = in_box(th, lo, hi)
        n0 = cl.free_feats.launches
        got, unmasked = lnprob(th), like(th)
        assert cl.free_feats.launches == n0 + 2
        assert got.dtype == dtype and unmasked.dtype == dtype
        assert torch.isneginf(got[~ok]).all()
        np.testing.assert_allclose(got[ok].cpu().numpy(),
                                   lnl[ok].cpu().numpy(), rtol=1e-4)
        np.testing.assert_allclose(unmasked[ok].cpu().numpy(),
                                   lnl[ok].cpu().numpy(), rtol=1e-4)
    th = edge_thetas(layout, 50, torch.float32, device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            lnprob(th)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(dev) <= 4 * 10


def test_value_and_grad_path_keeps_the_pytorch_map(device):
    """NUTS's value+gradient lnprob never launches ``free_feats``: its
    features come from the PyTorch map, whose Jacobian autograd takes."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=21)
    layout = ThetaLayout.from_config(cfg)
    lnpg = cl.make_cuda_lnprob_and_grad(_context(cfg, device), layout)
    lo, hi = layout.bounds_arrays(torch.float32, device)
    gen = torch.Generator(device=device).manual_seed(2)
    th = (0.7 * (lo + hi) / 2 + 0.3 * sample_init(
        gen, layout, 8, dtype=torch.float32, device=device)).requires_grad_()
    f0, v0 = cl.free_feats.launches, cl.free_lnlike_vg.launches
    lnpg(th).sum().backward()
    assert cl.free_feats.launches == f0
    assert cl.free_lnlike_vg.launches == v0 + 1
    assert torch.isfinite(th.grad).all()


def test_traced_step_loop_spans_are_host_events_only(device):
    """Under a profiler of host and device, the stretch run's ``lf.*``
    spans are host events alone (a device-side copy would read as device
    work on the trace's timeline), nested as on the CPU, and the traced
    run still makes no host sync."""
    from torch.profiler import ProfilerActivity, profile
    cfg = LFConfig(min_comp_frac=0.5, size_ln=21)
    layout = ThetaLayout.from_config(cfg)
    lnprob = cl.make_cuda_lnprob(_context(cfg, device), layout)
    gen = torch.Generator(device=device).manual_seed(0)
    pos0 = sample_init(gen, layout, 32, dtype=torch.float32, device=device)
    lnprob(pos0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_stretch(lnprob, pos0, gen, 5)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    host, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("lf."):
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append(e.name())
            else:
                host[e.name()] = host.get(e.name(), 0) + 1
    assert dev == []
    assert host == {"lf.step": 5, "lf.lnprob": 11, "lf.features": 11,
                    "lf.kernel": 11}


def _grad_close(gp, gref, rtol=2e-3):
    """The JAX package's gradient gate: relative per component, floored
    at 1e-3 of the row's largest component."""
    denom = np.maximum(np.abs(gref),
                       1e-3 * np.abs(gref).max(axis=-1, keepdims=True))
    np.testing.assert_array_less(np.abs(gp - gref) / denom, rtol)


def _vg_feats(cfg, layout, ctx, data, w, device):
    gen = torch.Generator(device=device).manual_seed(w)
    lo, hi = layout.bounds_arrays(torch.float32, device)
    th = sample_init(gen, layout, w, dtype=torch.float32, device=device)
    th = 0.7 * (lo + hi) / 2 + 0.3 * th         # where a chain moves
    return cl._features(th, data, layout, torch.float32).float()


@pytest.mark.parametrize("fix_comp", [False, True])
@pytest.mark.parametrize("w", [1, 13, 256])
def test_vg_kernel_matches_plain_version(device, fix_comp, w):
    """Each value+gradient kernel equals its plain version in float32 on
    the card: values rtol 1e-4, gradient columns by ``_grad_close``."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=41, fix_comp=fix_comp)
    layout = ThetaLayout.from_config(cfg)
    ctx = _context(cfg, device)
    data = cl.prepare_cuda_data(ctx, fix_comp, cfg.fcmin)
    feats = _vg_feats(cfg, layout, ctx, data, w, device)
    kernel = cl.fixed_lnlike_vg if fix_comp else cl.free_lnlike_vg
    plain = (cl.fixed_lnlike_vg_reference if fix_comp
             else cl.free_lnlike_vg_reference)
    n0 = kernel.launches
    got = kernel(feats, data).cpu().numpy()
    ref = plain(feats, data).cpu().numpy()
    assert kernel.launches == n0 + 1
    assert got.shape == (w, 1 + feats.shape[1])
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-4)
    _grad_close(got[:, 1:], ref[:, 1:])


def test_vg_wrapper_rejects_what_the_kernel_cannot_take(device):
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11)
    ctx = _context(cfg, device)
    data = cl.prepare_cuda_data(ctx, False, cfg.fcmin)
    fixed = cl.prepare_cuda_data(ctx, True)
    with pytest.raises(TypeError, match="float32"):
        cl.free_lnlike_vg(torch.zeros((4, 16), device=device,
                                      dtype=torch.float64), data)
    with pytest.raises(ValueError, match="features must be"):
        cl.free_lnlike_vg(torch.zeros((4, 15), device=device), data)
    with pytest.raises(ValueError, match="features must be"):
        cl.fixed_lnlike_vg(torch.zeros((4, 6), device=device), fixed)
    with pytest.raises(ValueError, match="launch range"):
        cl.fixed_lnlike_vg(torch.zeros((65536, 4), device=device), fixed)
    cpu_data = cl.prepare_cuda_data(_context(cfg, "cpu"), False, cfg.fcmin)
    with pytest.raises(ValueError, match="grid data on cpu"):
        cl.free_lnlike_vg(torch.zeros((4, 16), device=device), cpu_data)


def test_nuts_transition_through_the_kernels_matches_plain(device,
                                                            monkeypatch):
    """One float32 NUTS transition of 8 chains through the value+gradient
    kernel equals the same transition through the plain versions on the
    card, given the same numbers (1e-4)."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=41)
    layout = ThetaLayout.from_config(cfg)
    ctx = _context(cfg, device)
    lo, hi = layout.bounds_arrays(torch.float32, device)
    gen = torch.Generator(device=device).manual_seed(5)
    th = 0.8 * (lo + hi) / 2 + 0.2 * sample_init(
        gen, layout, 8, dtype=torch.float32, device=device)
    rands = nuts.generator_draw(gen, 8, layout.ndim, 5, torch.float32,
                                device)("s", 0)
    results = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(cl, "free_lnlike_vg",
                                cl.free_lnlike_vg_reference)
        lnp_y, _, to_y = nuts.make_unconstrained(
            cl.make_cuda_lnprob_and_grad(ctx, layout), lo, hi)
        n0 = cl.free_lnlike_vg.launches if not plain else 0
        counts = nuts.NutsCounts()
        out = nuts._nuts_step(nuts.value_and_grad(lnp_y), 5, 0.02, rands,
                              to_y(th), counts)
        if not plain:
            assert (cl.free_lnlike_vg.launches - n0
                    == counts.transitions + counts.leapfrogs)
        results.append([o.cpu().numpy() for o in out])
    (yk, vk, ak, dk), (yp, vp, ap, dp) = results
    np.testing.assert_array_equal(dk, dp)
    np.testing.assert_allclose(yk, yp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vk, vp, rtol=1e-4)
    np.testing.assert_allclose(ak, ap, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size_ln", [41, 12])
@pytest.mark.parametrize("w", [1, 13, 256])
def test_z_kernels_match_plain_versions(device, w, size_ln):
    """``z_lnlike`` and ``z_lnlike_vg`` equal their plain versions in
    float32 on the card (values rtol 1e-4, gradient columns by
    ``_grad_close``), on a grid with several L-row bands per field (41)
    and one with a single ragged band (12), with a row on a pivot bound
    and one far outside the box."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=size_ln, fix_comp=True)
    layout = ThetaLayoutZ.from_config(cfg)
    ctx = _context(cfg, device)
    data = cl.prepare_cuda_z_data(ctx, layout)
    gen = torch.Generator(device=device).manual_seed(w)
    lo, hi = layout.bounds_arrays(torch.float32, device)
    th = 0.7 * (lo + hi) / 2 + 0.3 * sample_init(
        gen, layout, w, dtype=torch.float32, device=device)
    th[0, 1] = layout.hi[1]
    th[-1, 0] = 1000.0
    feats = cl._features_z(th, data, layout, torch.float32).float()
    for kernel, plain, cols in (
            (cl.z_lnlike, cl.z_lnlike_reference, None),
            (cl.z_lnlike_vg, cl.z_lnlike_vg_reference, 8)):
        n0 = kernel.launches
        got = kernel(feats, data).cpu().numpy()
        ref = plain(feats, data).cpu().numpy()
        assert kernel.launches == n0 + 1
        assert got.shape == ((w, cols) if cols else (w,))
        assert np.isfinite(got).all()
        if cols:
            np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-4)
            _grad_close(got[:, 1:], ref[:, 1:])
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_z_wrappers_reject_what_the_kernels_cannot_take(device):
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11, fix_comp=True)
    layout = ThetaLayoutZ.from_config(cfg)
    data = cl.prepare_cuda_z_data(_context(cfg, device), layout)
    cpu_data = cl.prepare_cuda_z_data(_context(cfg, "cpu"), layout)
    for fn in (cl.z_lnlike, cl.z_lnlike_vg):
        with pytest.raises(TypeError, match="float32"):
            fn(torch.zeros((4, 7), device=device, dtype=torch.float64), data)
        with pytest.raises(ValueError, match="features must be"):
            fn(torch.zeros((4, 6), device=device), data)
        with pytest.raises(ValueError, match="launch range"):
            fn(torch.zeros((65536, 7), device=device), data)
        with pytest.raises(ValueError, match="grid data on cpu"):
            fn(torch.zeros((4, 7), device=device), cpu_data)


def test_z_step_loop_never_synchronises_and_is_deterministic(device):
    """The z model's stretch run under
    ``torch.cuda.set_sync_debug_mode("error")``, and the kernels' fixed
    summation order: the same call twice gives the same bits."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=21, fix_comp=True)
    layout = ThetaLayoutZ.from_config(cfg)
    ctx = _context(cfg, device)
    lnprob = cl.make_cuda_lnprob_z(ctx, layout)
    gen = torch.Generator(device=device).manual_seed(0)
    pos0 = sample_init(gen, layout, 32, dtype=torch.float32, device=device)
    first = lnprob(pos0)
    assert torch.equal(first, lnprob(pos0))
    post = cl.make_cuda_lnprob_and_grad(ctx, layout, model="z")
    t = pos0.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(post(t).sum(), t)
    (g2,) = torch.autograd.grad(post(t).sum(), t)
    assert torch.equal(g1, g2) and torch.isfinite(g1).all()
    torch.cuda.synchronize()
    n0 = cl.z_lnlike.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, chain, lnps, acc = run_stretch(lnprob, pos0, gen, 25)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cl.z_lnlike.launches - n0 == 1 + 2 * 25
    assert chain.shape == (25, 32, layout.ndim)
    assert torch.isfinite(lnps[-1]).all()


@pytest.mark.parametrize("fix_sch_al", [False, True])
@pytest.mark.parametrize("size_ln", [41, 12])
@pytest.mark.parametrize("w", [1, 13, 256])
def test_hier_kernels_match_plain_versions(device, w, size_ln, fix_sch_al):
    """``hier_lnlike`` and ``hier_lnlike_vg`` equal their plain versions
    in float32 on the card (values rtol 1e-4, gradient columns by
    ``_grad_close``), on a grid with one chunk per field (41, 12: a
    ragged one), in both theta layouts, with a ``sig_L = 0`` row and one
    far outside the box."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=size_ln, fix_comp=True,
                   fix_sch_al=fix_sch_al)
    layout = ThetaLayoutH.from_config(cfg)
    nf = layout.nfields
    data = cl.prepare_cuda_h_data(_context(cfg, device), layout)
    gen = torch.Generator(device=device).manual_seed(w)
    lo, hi = layout.bounds_arrays(torch.float32, device)
    th = 0.7 * (lo + hi) / 2 + 0.3 * sample_init(
        gen, layout, w, dtype=torch.float32, device=device)
    th[0, 1] = 0.0
    th[-1, layout.ndim - 2 * nf] = 1000.0
    feats = cl._features_hier(th, data, layout, torch.float32).float()
    assert feats.shape == (w, 1 + 3 * nf) and torch.isfinite(feats).all()
    for kernel, plain, cols in (
            (cl.hier_lnlike, cl.hier_lnlike_reference, None),
            (cl.hier_lnlike_vg, cl.hier_lnlike_vg_reference, 2 + 3 * nf)):
        n0 = kernel.launches
        got = kernel(feats, data).cpu().numpy()
        ref = plain(feats, data).cpu().numpy()
        assert kernel.launches == n0 + 1
        assert got.shape == ((w, cols) if cols else (w,))
        assert np.isfinite(got).all()
        if cols:
            np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-4)
            _grad_close(got[:, 1:], ref[:, 1:])
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_hier_wrappers_reject_what_the_kernels_cannot_take(device):
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11, fix_comp=True)
    layout = ThetaLayoutH.from_config(cfg)
    data = cl.prepare_cuda_h_data(_context(cfg, device), layout)
    cpu_data = cl.prepare_cuda_h_data(_context(cfg, "cpu"), layout)
    for fn in (cl.hier_lnlike, cl.hier_lnlike_vg):
        with pytest.raises(TypeError, match="float32"):
            fn(torch.zeros((4, 16), device=device, dtype=torch.float64),
               data)
        with pytest.raises(ValueError, match="features must be"):
            fn(torch.zeros((4, 5), device=device), data)
        with pytest.raises(ValueError, match="launch range"):
            fn(torch.zeros((65536, 16), device=device), data)
        with pytest.raises(ValueError, match="grid data on cpu"):
            fn(torch.zeros((4, 16), device=device), cpu_data)


def test_hier_step_loop_never_synchronises_and_is_deterministic(device):
    """The hierarchical model's stretch run under
    ``torch.cuda.set_sync_debug_mode("error")``, and the kernels' fixed
    summation order: the same call twice gives the same bits. A masked
    row's gradient is an exact 0 through the kernel too."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=21, fix_comp=True)
    layout = ThetaLayoutH.from_config(cfg)
    ctx = _context(cfg, device)
    lnprob = cl.make_cuda_lnprob_h(ctx, layout)
    gen = torch.Generator(device=device).manual_seed(0)
    pos0 = sample_init(gen, layout, 32, dtype=torch.float32, device=device)
    first = lnprob(pos0)
    assert torch.equal(first, lnprob(pos0))
    post = cl.make_cuda_lnprob_and_grad(ctx, layout, model="hier")
    t = pos0.clone()
    t[0, 1] = -1.0
    t.requires_grad_(True)
    n0 = cl.hier_lnlike_vg.launches
    v = post(t)
    (g1,) = torch.autograd.grad(v.sum(), t)
    (g2,) = torch.autograd.grad(post(t).sum(), t)
    assert cl.hier_lnlike_vg.launches == n0 + 2
    assert torch.equal(g1, g2) and torch.isfinite(g1).all()
    assert torch.isneginf(v[0]) and (g1[0] == 0).all() and (
        g1[1:] != 0).any()
    torch.cuda.synchronize()
    n0 = cl.hier_lnlike.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, chain, lnps, acc = run_stretch(lnprob, pos0, gen, 25)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cl.hier_lnlike.launches - n0 == 1 + 2 * 25
    assert chain.shape == (25, 32, layout.ndim)
    assert torch.isfinite(lnps[-1]).all()


def _one_launch_case(device, fam, size_ln, suffix="_vg", nfields=5,
                     fcmin=LFConfig.fcmin):
    """The data of ``free_lnlike_vg`` (free completeness with ``fcmin``),
    ``fixed_lnlike_vg``, ``hier_lnlike_vg`` or ``z_lnlike_vg`` (with
    ``suffix`` "": the value kernels ``free_lnlike``, ``fixed_lnlike``,
    ``hier_lnlike``, ``z_lnlike``) on a 400-source catalog of the first
    ``nfields`` default fields, its kernel, plain version and a function of
    W giving W feature rows near the box centre."""
    d = LFConfig()
    cfg = LFConfig(min_comp_frac=0.5, size_ln=size_ln,
                   fix_comp=fam != "free", Flim=d.Flim[:nfields],
                   Omega_0=d.Omega_0[:nfields],
                   survey_fields=d.survey_fields[:nfields], fcmin=fcmin)
    ctx = _context(cfg, device)
    if fam == "hier":
        layout = ThetaLayoutH.from_config(cfg)
        data, features = (cl.prepare_cuda_h_data(ctx, layout),
                          cl._features_hier)
    elif fam == "z":
        layout = ThetaLayoutZ.from_config(cfg)
        data, features = (cl.prepare_cuda_z_data(ctx, layout),
                          cl._features_z)
    elif fam == "fixed":
        layout = ThetaLayout.from_config(cfg)
        data, features = cl.prepare_cuda_data(ctx, True), cl._features
    else:
        layout = ThetaLayout.from_config(cfg)
        data, features = (cl.prepare_cuda_data(ctx, False, cfg.fcmin),
                          cl._features)
    lo, hi = layout.bounds_arrays(torch.float32, device)

    def feats(w):
        gen = torch.Generator(device=device).manual_seed(w)
        th = 0.7 * (lo + hi) / 2 + 0.3 * sample_init(
            gen, layout, w, dtype=torch.float32, device=device)
        return features(th, data, layout, torch.float32).float()

    kernel = getattr(cl, f"{fam}_lnlike{suffix}")
    return (data, kernel, getattr(cl, f"{fam}_lnlike{suffix}_reference"),
            feats)


@pytest.mark.parametrize("fam,size_ln", [
    ("free", 12), ("free", 41), ("hier", 12), ("hier", 41), ("fixed", 12),
    ("fixed", 41), ("z", 12), ("z", 41), ("z", 300)])
def test_one_launch_vg_kernels_at_every_batch(device, fam, size_ln):
    """The value+gradient kernels (one launch each, a walker tile's last
    block finishing its rows through the data's tickets) at W = 1, 8, 13
    and 256, back to back on one data object, on grids of several pieces a
    field and of one ragged piece (the z model's also on one of 300 z
    nodes, more than a block's threads): each equals the plain version
    (values rtol 1e-4, gradients by ``_grad_close``), two launches on one
    input are bit-identical, W = 8 again after W = 256 gives the first W =
    8 rows bit for bit (every launch leaves the tickets at 0), and a CUDA
    graph of the W = 8 call replayed twice gives those rows too."""
    data, kernel, plain, feats = _one_launch_case(device, fam, size_ln)
    rows = {}
    for w in (1, 8, 13, 256, 8):
        f = feats(w)
        n0 = kernel.launches
        got, again = kernel(f, data), kernel(f, data)
        assert kernel.launches == n0 + 2
        assert torch.equal(got, again)
        assert torch.equal(rows.setdefault(w, got), got)
        ref = plain(f, data).cpu().numpy()
        np.testing.assert_allclose(got[:, 0].cpu().numpy(), ref[:, 0],
                                   rtol=1e-4)
        _grad_close(got[:, 1:].cpu().numpy(), ref[:, 1:])
        assert not data.vg_tickets.any()
    f = feats(8)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(f, data)
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, rows[8]) and torch.equal(out, rows[8])
    assert not data.vg_tickets.any()


@pytest.mark.parametrize("fam,tile,size_ln", [
    (fam, tile, size_ln) for fam in ("free", "hier", "fixed", "z")
    for tile in cl.VG_TILES[fam]
    for size_ln in ((12, 41, 300) if fam == "z" else (41,))])
def test_one_launch_vg_kernels_at_every_walker_tile(device, monkeypatch,
                                                     fam, tile, size_ln):
    """Every walker-tile instance of the value+gradient kernels, whatever
    the geometry rule would take on this card, at W = 13 (a partial last
    tile) and the shortest pieces (4 a field at 41 cells a side; the z
    model's bands also at 12 and 300 z nodes, where its lanes map
    otherwise): the plain version's rows, two launches bit-identical, the
    tickets left at 0."""
    data, kernel, plain, feats = _one_launch_case(device, fam, size_ln)
    piece = min(p for p, _, _ in data.vg_tables)
    monkeypatch.setattr(cl, "_vg_geometry", lambda *a: (tile, piece))
    f = feats(13)
    got, again = kernel(f, data), kernel(f, data)
    assert torch.equal(got, again)
    ref = plain(f, data).cpu().numpy()
    np.testing.assert_allclose(got[:, 0].cpu().numpy(), ref[:, 0],
                               rtol=1e-4)
    _grad_close(got[:, 1:].cpu().numpy(), ref[:, 1:])
    assert not data.vg_tickets.any()


@pytest.mark.parametrize("fam,size_ln,fcmin", [
    ("hier", 12, 0.1), ("hier", 41, 0.1), ("z", 12, 0.1), ("z", 41, 0.1),
    ("z", 300, 0.1), ("free", 12, 0.1), ("free", 41, 0.1), ("free", 41, 0.0),
    ("fixed", 12, 0.1), ("fixed", 41, 0.1)])
def test_one_launch_value_kernels_at_every_batch(device, fam, size_ln, fcmin):
    """The value kernels of the stretch paths (one launch each, a walker
    tile's last block finishing its values through the data's tickets) at
    W = 1, 13, 50, 100, 800 (an evidence ladder's half-step) and 2400 (the
    NUTS recompute's 300 samples x 8 chains), and 65,535 (a ladder
    recompute's chunk) on the 12-node grids, back to back on one data
    object (free completeness with
    ``fcmin`` 0 and 0.1): each equals the plain version (rtol 1e-4), two
    launches on one input are bit-identical, W = 50 again after W = 2400
    gives the first W = 50 values bit for bit, and a CUDA graph of the W =
    50 call replayed twice gives them too; the tickets are left at 0."""
    data, kernel, plain, feats = _one_launch_case(device, fam, size_ln, "",
                                                  fcmin=fcmin)
    vals = {}
    # 800: an evidence ladder's half-step (16 rungs x 100 walkers / 2);
    # 65,535 (MAX_ROWS): its lnlike recompute's chunk, on the small grid
    # where the plain version's (W, cells) temporaries stay small
    batches = (1, 13, 50, 100, 800, 2400) + ((cl.MAX_ROWS,) if size_ln == 12
                                             else ()) + (50,)
    for w in batches:
        f = feats(w)
        n0 = kernel.launches
        got, again = kernel(f, data), kernel(f, data)
        assert kernel.launches == n0 + 2
        assert got.shape == (w,) and got.dtype == torch.float64
        assert torch.equal(got, again)
        assert torch.equal(vals.setdefault(w, got), got)
        np.testing.assert_allclose(got.cpu().numpy(),
                                   plain(f, data).cpu().numpy(), rtol=1e-4)
        assert not data.vg_tickets.any()
    f = feats(50)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(f, data)
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, vals[50]) and torch.equal(out, vals[50])
    assert not data.vg_tickets.any()


_VALUE_TILE_CASES = {
    "z": ((12, 5, 0.1), (41, 5, 0.1), (300, 5, 0.1), (41, 2, 0.1),
          (41, 4, 0.1)),
    "hier": ((41, 5, 0.1), (41, 4, 0.1)),
    "fixed": ((41, 5, 0.1), (41, 4, 0.1), (41, 2, 0.1)),
    "free": ((41, 5, 0.1), (41, 4, 0.1), (41, 2, 0.1), (41, 5, 0.0),
             (41, 2, 0.0))}


@pytest.mark.parametrize("fam,tile,size_ln,nfields,fcmin", [
    (fam, tile, *case) for fam in ("hier", "z", "fixed", "free")
    for tile in cl.VG_TILES[f"{fam}_value"]
    for case in _VALUE_TILE_CASES[fam]])
def test_one_launch_value_kernels_at_every_walker_tile(device, monkeypatch,
                                                        fam, tile, size_ln,
                                                        nfields, fcmin):
    """Every walker-tile instance of the value kernels, whatever the
    geometry rule would take on this card, at W = 13 (a partial last tile
    at every tile but 1) and 2400 on the shortest and the longest pieces (the
    z model's bands also at 12 and 300 z nodes), on catalogs of 5 fields and
    of an even number (an odd segment count, where the z kernels' node
    quantities follow an odd number of double segment sums at tile 1; free
    completeness has a grid and a source segment a field, so 2F segments),
    free completeness with ``fcmin`` 0 and 0.1: the plain version's values,
    two launches bit-identical, the tickets left at 0."""
    data, kernel, plain, feats = _one_launch_case(device, fam, size_ln, "",
                                                  nfields, fcmin)
    lengths = [p for p, _, _ in data.vg_tables]
    for piece in (min(lengths), max(lengths)):
        monkeypatch.setattr(cl, "_vg_geometry",
                            lambda *a, g=(tile, piece): g)
        for w in (13, 2400):
            f = feats(w)
            got, again = kernel(f, data), kernel(f, data)
            assert torch.equal(got, again)
            np.testing.assert_allclose(got.cpu().numpy(),
                                       plain(f, data).cpu().numpy(),
                                       rtol=1e-4)
            assert not data.vg_tickets.any()


def _stream_case(device, w, nshards=1, seed=0):
    """A 400-source catalog in the streaming layout and ``w`` feature rows
    near the box centre."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=41)
    layout = ThetaLayout.from_config(cfg)
    ctx = _context(cfg, device, dtype=torch.float64)
    data = cl.prepare_cuda_stream_data(ctx, cfg.fcmin, nshards=nshards,
                                       dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed + w)
    lo, hi = layout.bounds_arrays(torch.float64, device)
    th = 0.7 * (lo + hi) / 2 + 0.3 * sample_init(
        gen, layout, w, dtype=torch.float64, device=device)
    feats = cl._features_stream(th, data, layout, torch.float32)
    return cfg, layout, ctx, data, th, feats.float().contiguous()


def _stream_feats_case(device, fcmin):
    """The 400-source catalog of :func:`_stream_case` in the streaming
    layout at ``fcmin``, its layout, data and ``stream_feats`` spec (the
    box in float64, as a float64 run holds it)."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=41, fcmin=fcmin)
    layout = ThetaLayout.from_config(cfg)
    ctx = _context(cfg, device, dtype=torch.float64)
    data = cl.prepare_cuda_stream_data(ctx, cfg.fcmin, dtype=torch.float32)
    lo, hi = layout.bounds_arrays(torch.float64, device)
    return cfg, layout, ctx, data, cl.stream_feats_spec(data, layout, lo, hi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fcmin", [0.1, 0.0])
def test_stream_feats_kernel_matches_the_pytorch_map(device, fcmin, dtype):
    """``stream_feats`` on the card against the PyTorch map it replaces,
    run on the card (``_features_stream`` rounded to float32, ``in_box``,
    ``_stream_collapsed``), at W = 1, 50 and 257 with rows out of the box
    (Flim <= 0, NaN, beyond ``hi``): every feature within 1 float32 ulp,
    >= 99.9% of them the same number, NaN where the map gives NaN, the
    flags equal, the collapsed column ``_stream_collapsed`` of the kernel's
    own rows bit for bit; one launch a call."""
    from test_torch_free_feats import edge_thetas
    _, layout, _, data, spec = _stream_feats_case(device, fcmin)
    for w in (1, 50, 257):
        th = edge_thetas(layout, w, dtype, device, seed=w)
        n0 = cl.stream_feats.launches
        feats, ok, coll = cl.stream_feats(th, spec)
        assert cl.stream_feats.launches == n0 + 1
        want = cl._features_stream(th, data, layout, torch.float32).float()
        assert feats.shape == want.shape and feats.dtype == torch.float32
        assert torch.equal(feats.isnan(), want.isnan())
        ulps, same = _ulps(feats, want)
        assert int(ulps.max()) <= 1
        assert float(same.float().mean()) >= 0.999
        assert torch.equal(ok, in_box(th, spec.lo, spec.hi))
        assert int((~ok).sum()) == min(w, 7)
        assert coll.dtype == torch.float64 and coll.shape == (w,)
        torch.testing.assert_close(
            coll, cl._stream_collapsed(feats.double(), data), rtol=0,
            atol=0, equal_nan=True)
        assert torch.isfinite(coll[ok]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stream_value_path_is_the_pytorch_maps(device, monkeypatch, dtype):
    """``make_cuda_lnprob`` on the streaming route (gate lowered) through
    ``stream_feats`` against the PyTorch map's route (``_features_stream``,
    ``free_stream_lnlike``, ``_stream_collapsed``) on the card: equal
    where the kernel's rows are the map's, 1e-9 relative elsewhere, -inf
    outside the box; one ``stream_feats`` and one value kernel launch a
    call, and a call makes at most 5 device launches."""
    from torch.profiler import ProfilerActivity, profile

    from test_torch_free_feats import edge_thetas
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    _, layout, ctx, data, spec = _stream_feats_case(device, 0.1)
    lnprob = cl.make_cuda_lnprob(ctx, layout)
    assert lnprob.engine == "cuda-stream"
    for w in (1, 50, 257):
        th = edge_thetas(layout, w, dtype, device, seed=w + 1)
        rows = cl._features_stream(th, data, layout, torch.float32)
        lnl = (cl.free_stream_lnlike(rows.float(), lnprob.data)
               + cl._stream_collapsed(rows, lnprob.data)).to(dtype)
        ok = in_box(th, spec.lo, spec.hi)
        kept = (cl.stream_feats(th, spec)[0] == rows.float()).all(dim=1)
        n0, v0 = cl.stream_feats.launches, cl.free_stream_lnlike.launches
        got = lnprob(th)
        assert cl.stream_feats.launches == n0 + 1
        assert cl.free_stream_lnlike.launches == v0 + 1
        assert got.dtype == dtype
        assert torch.isneginf(got[~ok]).all() and torch.isfinite(got[ok]).all()
        assert torch.equal(got[ok & kept], lnl[ok & kept])
        np.testing.assert_allclose(got[ok].cpu().numpy(),
                                   lnl[ok].cpu().numpy(), rtol=1e-9)
    th = edge_thetas(layout, 50, torch.float64, device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            lnprob(th)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(dev) <= 5 * 10


@pytest.mark.parametrize("w", [1, 13, 64])
def test_stream_kernel_matches_plain_version(device, w):
    """free_stream_lnlike equals its plain version on the card (rtol 1e-5:
    float32 terms summed in double in another order), in float64."""
    _, _, _, data, _, feats = _stream_case(device, w)
    n0 = cl.free_stream_lnlike.launches
    got = cl.free_stream_lnlike(feats, data)
    ref = cl.free_stream_lnlike_reference(feats, data)
    assert cl.free_stream_lnlike.launches == n0 + 1
    assert got.dtype == torch.float64 and got.shape == (w,)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("w", [1, 13, 256])
def test_stream_vg_kernel_matches_plain_version(device, w):
    """free_stream_lnlike_vg equals its plain version on the card: values
    rtol 1e-5, gradient columns by ``_grad_close``."""
    _, _, _, data, _, feats = _stream_case(device, w)
    n0 = cl.free_stream_lnlike_vg.launches
    got = cl.free_stream_lnlike_vg(feats, data).cpu().numpy()
    ref = cl.free_stream_lnlike_vg_reference(feats, data).cpu().numpy()
    assert cl.free_stream_lnlike_vg.launches == n0 + 1
    assert got.shape == (w, 1 + feats.shape[1])
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5)
    assert (got[:, 2] == 0).all()
    cols = [c for c in range(1, got.shape[1]) if c != 2]
    _grad_close(got[:, cols], ref[:, cols])


def test_stream_kernels_match_plain_versions_without_fcmin(device):
    """The fcmin = 0 branch of both streaming kernels (no faint-end decay
    term: t2 unused, its gradient columns 0) against their plain versions
    on the card: values rtol 1e-5, gradient columns by ``_grad_close``."""
    cfg = LFConfig(min_comp_frac=0.5, size_ln=41, fcmin=0.0)
    layout = ThetaLayout.from_config(cfg)
    ctx = _context(cfg, device, dtype=torch.float64)
    data = cl.prepare_cuda_stream_data(ctx, cfg.fcmin, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(13)
    lo, hi = layout.bounds_arrays(torch.float64, device)
    th = 0.7 * (lo + hi) / 2 + 0.3 * sample_init(
        gen, layout, 13, dtype=torch.float64, device=device)
    feats = cl._features_stream(th, data, layout,
                                torch.float32).float().contiguous()
    np.testing.assert_allclose(
        cl.free_stream_lnlike(feats, data).cpu().numpy(),
        cl.free_stream_lnlike_reference(feats, data).cpu().numpy(),
        rtol=1e-5)
    got = cl.free_stream_lnlike_vg(feats, data).cpu().numpy()
    ref = cl.free_stream_lnlike_vg_reference(feats, data).cpu().numpy()
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-5)
    nf = layout.nfields
    assert (got[:, 7 + nf:] == 0).all() and (got[:, 2] == 0).all()
    _grad_close(got[:, [1, 3, 4, 5, 6] + list(range(7, 7 + nf))],
                ref[:, [1, 3, 4, 5, 6] + list(range(7, 7 + nf))])


def test_stream_shards_sum_to_the_whole(device):
    """At 2 shards each shard's kernel equals its plain version, and the
    shards' sum (kernel + collapsed terms) equals one shard's (1e-6)."""
    _, layout, ctx, one, th, f1 = _stream_case(device, 13)
    two = cl.prepare_cuda_stream_data(ctx, 0.1, nshards=2,
                                      dtype=torch.float32)
    f2 = cl._features_stream(th, two, layout, torch.float32)
    tot = 0.0
    for k in range(2):
        got = cl.free_stream_lnlike(f2.float().contiguous(), two, k)
        ref = cl.free_stream_lnlike_reference(f2.float(), two, k)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5)
        tot = tot + got + cl._stream_collapsed(f2, two, k)
    whole = cl.free_stream_lnlike(f1, one) + cl._stream_collapsed(
        f1.double(), one)
    np.testing.assert_allclose(tot.cpu().numpy(), whole.cpu().numpy(),
                               rtol=1e-6)


def test_stream_wrappers_reject_what_the_kernels_cannot_take(device):
    _, _, _, data, _, feats = _stream_case(device, 4)
    for fn in (cl.free_stream_lnlike, cl.free_stream_lnlike_vg):
        with pytest.raises(TypeError, match="float32"):
            fn(feats.double(), data)
        with pytest.raises(ValueError, match="features must be"):
            fn(feats[:, :-1].contiguous(), data)
        with pytest.raises(ValueError, match="shard"):
            fn(feats, data, 1)
    cfg = LFConfig(min_comp_frac=0.5, size_ln=11)
    cpu_data = cl.prepare_cuda_stream_data(_context(cfg, "cpu"), 0.1)
    with pytest.raises(ValueError, match="grid data on cpu"):
        cl.free_stream_lnlike(feats, cpu_data)


def test_stream_step_loop_never_synchronises_and_is_deterministic(
        device, monkeypatch):
    """The stretch run through the streaming engine (gate lowered, float64
    lnprob) under ``torch.cuda.set_sync_debug_mode("error")``; the same
    call twice gives the same bits, value and gradient, and a masked
    row's gradient is an exact 0."""
    monkeypatch.setattr(cl, "STREAM_MIN_SOURCES", 0)
    cfg = LFConfig(min_comp_frac=0.5, size_ln=21)
    layout = ThetaLayout.from_config(cfg)
    ctx = _context(cfg, device, dtype=torch.float64)
    lnprob = cl.make_cuda_lnprob(ctx, layout)
    assert lnprob.engine == "cuda-stream"
    gen = torch.Generator(device=device).manual_seed(0)
    pos0 = sample_init(gen, layout, 32, dtype=torch.float64, device=device)
    first = lnprob(pos0)
    assert first.dtype == torch.float64 and torch.equal(first, lnprob(pos0))
    post = cl.make_cuda_lnprob_and_grad(ctx, layout)
    t = pos0.clone()
    t[0, 3] = -1.0
    t.requires_grad_(True)
    n0 = cl.free_stream_lnlike_vg.launches
    v = post(t)
    (g1,) = torch.autograd.grad(v.sum(), t)
    (g2,) = torch.autograd.grad(post(t).sum(), t)
    assert cl.free_stream_lnlike_vg.launches == n0 + 2
    assert torch.equal(g1, g2) and torch.isfinite(g1).all()
    assert torch.isneginf(v[0]) and (g1[0] == 0).all()
    torch.cuda.synchronize()
    n0 = cl.free_stream_lnlike.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, chain, lnps, acc = run_stretch(lnprob, pos0, gen, 25)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cl.free_stream_lnlike.launches - n0 == 1 + 2 * 25
    assert torch.isfinite(lnps[-1]).all()


def test_roofline_kernel_matches_plain_version(device):
    """roofline_chain equals its plain version on the card after 8
    iterations (rtol 1e-5: the chain contracts, nvcc may fuse a
    multiply-add that PyTorch rounds twice, and the kernel's log and
    divide are the SFU's), also at a size that is not a whole number of
    blocks of 256 x E elements, and the peak is positive."""
    from lumfuncmcmc_tpu_torch.ops import roofline as rl
    for shape in ((64, 1024), (3, 1000), (1,)):
        x = 0.05 + 0.9 * torch.rand(shape, device=device)
        n0 = rl.roofline_chain.launches
        got = rl.roofline_chain(x, 8)
        assert rl.roofline_chain.launches == n0 + 1
        np.testing.assert_allclose(
            got.cpu().numpy(),
            rl.roofline_chain_reference(x, 8).cpu().numpy(), rtol=1e-5)
    lay = rl.kernel_layout(3000)
    assert lay["chains_per_thread"] > 1 and lay["local_bytes"] == 0
    assert lay["blocks"] * lay["threads"] * lay["chains_per_thread"] >= 3000
    r = rl.transcendental_peak(device, rows=64, cols=1024, iters_lo=16,
                               iters_hi=144, reps=3)
    assert r["transcendentals_per_sec"] > 0
