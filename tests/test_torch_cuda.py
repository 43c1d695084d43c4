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
from lumfuncmcmc_tpu_torch.models.likelihood import ThetaLayout, sample_init
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
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
    th = cl._clamp_flim(sample_init(gen, layout, w, dtype=torch.float32,
                                    device=device), layout)
    before = (cl.free_lnlike.launches, cl.fixed_lnlike.launches)
    if fix_comp:
        feats = cl._features_fixed(th, ctx, layout, data.lref,
                                   torch.float32)
        got = cl.fixed_lnlike(feats, data)
        ref = cl.fixed_lnlike_reference(feats, data)
    else:
        feats = cl._features_free(th, layout, data.lref, data.fcmin,
                                  torch.float32)
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
    n0 = cl.free_lnlike.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, chain, lnps, acc = run_stretch(lnprob, pos0, gen, 25,
                                              move="mix")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cl.free_lnlike.launches - n0 == 1 + 2 * 25
    assert chain.shape == (25, 32, layout.ndim)
    assert torch.isfinite(lnps[-1]).all()
    assert 0 < float(acc.sum()) < 25 * 32
