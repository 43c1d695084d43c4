"""The stretch half-step's two kernels (``csrc/stretch.cu``:
``stretch_propose``, ``stretch_accept``) behind ``ops/stretch.py``, which
the sampler's ``_half_step`` calls.

On the CPU: what the launches are given for the callers' operands (a
library that records them, CPU tensors read as on card 0), what they
refuse, and that everything on the CPU runs the eager ops with their bits
and never launches. On the card (marker ``cuda``; no jax here):

    python -m pytest --noconftest -m cuda tests/test_torch_stretch_kernels.py

the kernels against the eager body on the same randoms, bit for bit.
"""

import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu_torch.ops import _build, stretch
from lumfuncmcmc_tpu_torch.samplers import affine, tempering


def _eager_half_step(rand, move_pos, move_lnp, other_pos, lnprob_batch, a,
                     ndim):
    """The half-step's eager body as it stood before the kernels."""
    u_z, j, ln_u = rand
    z = ((a - 1.0) * u_z + 1.0) ** 2 / a
    partner = affine._pick(other_pos, j)
    prop = partner + z[..., None] * (move_pos - partner)
    lnp_prop = lnprob_batch(prop)
    ln_ratio = (ndim - 1.0) * torch.log(z) + lnp_prop - move_lnp
    accept = ln_u < ln_ratio
    new_pos = torch.where(accept[..., None], prop, move_pos)
    new_lnp = torch.where(accept, lnp_prop, move_lnp)
    return new_pos, new_lnp, accept


def _gauss(th):
    """A box-bounded Gaussian lnprob, (..., D) -> (...): -inf outside
    |theta| <= 2, so some proposals fall out."""
    lnp = -0.5 * (th * th).sum(-1)
    return torch.where((th.abs() <= 2.0).all(-1), lnp,
                       torch.full_like(lnp, -torch.inf))


def _bits(t):
    """``t`` as integers of its width: equal bits, NaN included."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _flat(out):
    """The tensors of a sampler's (nested) return, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in _flat(x)]


def _assert_same_bits(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


class _Library:
    """The kernel library's two stretch entry points, recording each
    launch's arguments."""

    def __init__(self):
        self.calls = []

    def stretch_propose_launch(self, *args):
        self.calls.append(args)
        return 0

    def stretch_accept_launch(self, *args):
        self.calls.append(args)
        return 0


def _operands(case):
    """One half-step's ``(u_z, j, ln_u, move_pos, move_lnp, other_pos)``
    as the callers slice them, and the launches' ``(K, n, m, D)`` and
    batch strides of ``(u_z, j, ln_u, move_lnp, move_pos, other_pos)``
    (None: the wrappers refuse them)."""
    W, D, nsteps, dt = 10, 3, 4, torch.float32
    nh = W // 2
    g = torch.Generator().manual_seed(1)
    if case == "ladder":                       # tempering's rung slices
        K = 3
        u, jj, lu = (torch.stack([x] * K) for x in affine._stretch_rands(
            g, nsteps, nh, dt, "cpu"))
        u, jj, lu = (x[:, 2][:, 1] for x in (u, jj, lu))
        pos, lnp = torch.zeros((K, W, D)), torch.zeros((K, W))
        want = (K, nh, nh, D, (nsteps * 2 * nh,) * 3 + (W, W * D, W * D))
    else:
        batch = {"ensembles": (2,), "two_batch_axes": (2, 3)}.get(case, ())
        u, jj, lu = (x[2][1] for x in affine._stretch_rands(
            g, nsteps, nh, dt, "cpu", batch))
        pos = torch.zeros(batch + (W, D), dtype=dt)
        lnp = torch.zeros(batch + (W,), dtype=dt)
        want = {"plain": (1, nh, nh, D, (0,) * 6),
                "strided_rows": (1, nh, nh, D, (0,) * 6),
                "ensembles": (2, nh, nh, D, (nh, nh, nh, W, W * D, W * D)),
                "two_batch_axes": (6, nh, nh, D,
                                   (nh, nh, nh, W, W * D, W * D)),
                }.get(case)
    ops = [u, jj, lu, pos[..., nh:, :], lnp[..., nh:], pos[..., :nh, :]]
    if case == "float16":
        ops = [t.half() if t.is_floating_point() else t for t in ops]
    elif case == "mixed_dtypes":
        ops[4] = ops[4].double()
    elif case == "strided_rows":
        ops[3] = torch.zeros((W, 2 * D))[nh:, ::2]
    elif case == "broadcast_randoms":
        ops[3], ops[4], ops[5] = (torch.zeros((2,) + t.shape)
                                  for t in ops[3:])
    return ops, want


def _launches(ops):
    """One half-step's two launches of ``ops``; returns the arguments
    each entry point was given."""
    u, j, lu, pos, lnp, other = ops
    prop = stretch._launch_propose("stretch_propose", pos, other, u, j, 2.0)
    stretch._launch_accept("stretch_accept", prop, torch.zeros_like(lnp),
                           pos, lnp, u, lu, 2.0, pos.shape[-1])
    return prop


@pytest.mark.parametrize("case", [
    "plain", "ensembles", "ladder", "cpu", "float16", "mixed_dtypes",
    "strided_rows", "broadcast_randoms", "two_batch_axes"])
def test_rule_gives_the_kernels_dense_rows_of_one_dtype_on_the_card(
        case, monkeypatch):
    """On the card the kernels take float32 or float64 operands of one
    dtype and of the walkers' shape, the leading axes one batch axis with
    a stride of its own: the callers' views as they are (one ensemble,
    the halves of an (E, W, D) state, the ladder's per-rung randoms), rows
    that are not dense as a dense copy, two batch axes as one; other
    dtypes, mixed dtypes or randoms of another shape raise. On the CPU the
    wrappers run the eager ops and touch no library."""
    ops, want = _operands(case)
    if case == "cpu":
        monkeypatch.setattr(_build, "_lib", object())
        u, j, lu, pos, lnp, other = ops
        n0 = stretch.stretch_propose.launches, stretch.stretch_accept.launches
        prop = stretch.stretch_propose(pos, other, u, j, 2.0)
        got = stretch.stretch_accept(prop, lnp, pos, lnp, u, lu, 2.0, 3)
        _assert_same_bits((prop, got), (
            stretch.stretch_propose_reference(pos, other, u, j, 2.0),
            stretch.stretch_accept_reference(prop, lnp, pos, lnp, u, lu, 2.0,
                                             3)))
        assert (stretch.stretch_propose.launches,
                stretch.stretch_accept.launches) == n0
        return
    lib = _Library()
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    if want is None:
        with pytest.raises(TypeError, match="stretch kernels"):
            _launches(ops)
        return
    prop = _launches(ops)
    (p_u, p_j, p_x, p_o, p_p, *geom), acc = lib.calls
    k, n, m, d, strides = want
    s_u, s_j, s_l, s_lnp, s_x, s_o = strides
    assert tuple(geom[:8]) == (k, n, m, d, s_u, s_j, s_x, s_o)
    s_q = 0 if case in ("plain", "strided_rows") else n  # zeros_like's
    assert tuple(acc[9:17]) == (k, n, d, s_u, s_l, s_q, s_x, s_lnp)
    assert acc[2] == p_p == prop.data_ptr() and prop.is_contiguous()
    u, j, lu, pos, lnp, other = ops
    views = (p_u, p_j, acc[1], acc[5], p_o)
    assert views == tuple(t.data_ptr() for t in (u, j, lu, lnp, other))
    copied = case == "strided_rows"            # a dense copy a launch
    assert (p_x == pos.data_ptr(), acc[4] == pos.data_ptr()) == (
        not copied, not copied)


def _run(case, half_step):
    """``case`` on the CPU with ``half_step`` in place of the sampler's:
    the public ``step``, a run of E ensembles, or the tempered ladder."""
    g = torch.Generator().manual_seed(7)
    dt = {"step_float16": torch.float16,
          "step_float32": torch.float32}.get(case, torch.float64)
    saved = affine._half_step, tempering._half_step
    affine._half_step = tempering._half_step = half_step
    try:
        if case.startswith("step"):
            pos = (torch.rand((12, 4), generator=g) * 3 - 1.5).to(dt)
            state = affine.EnsembleState(pos, _gauss(pos))
            out = []
            for _ in range(5):
                state, acc = affine.step(g, state, _gauss)
                out += [state.pos, state.lnp, acc]
            return out
        if case == "ensembles":
            pos = torch.rand((3, 12, 4), generator=g, dtype=dt) * 3 - 1.5
            return affine.run_stretch_ensembles(_gauss, pos, g, 20, thin=2)
        betas = np.array([0.0, 0.3, 1.0])
        pos = torch.rand((3, 12, 4), generator=g, dtype=dt) * 3 - 1.5
        return tempering.run_tempered(lambda t: torch.zeros_like(t[..., 0]),
                                      _gauss, pos, betas, g, 20)
    finally:
        affine._half_step, tempering._half_step = saved


@pytest.mark.parametrize("case", ["step_float64", "step_float32",
                                  "step_float16", "ensembles", "ladder"])
def test_off_the_card_the_eager_body_runs_with_its_bits(case):
    """The CPU (and float16, whatever the device) runs the half-step's
    eager body: the public ``step``, replicated ensembles and the
    tempered ladder return the bits of the body as it stood, and no
    stretch kernel launches."""
    launches = (stretch.stretch_propose.launches,
                stretch.stretch_accept.launches)
    got = _run(case, affine._half_step)
    want = _run(case, _eager_half_step)
    _assert_same_bits(_flat(got), _flat(want))
    assert (stretch.stretch_propose.launches,
            stretch.stretch_accept.launches) == launches == (0, 0)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stretch kernels run only there")
    return torch.device("cuda:0")


def _free_lnprob(device, dtype, nfields):
    """The free-completeness lnprob of a small catalog through the value
    kernels, and its layout: D = 4 + ``nfields``."""
    from lumfuncmcmc_tpu_torch import LFConfig
    from lumfuncmcmc_tpu_torch.models.context import build_context
    from lumfuncmcmc_tpu_torch.models.likelihood import ThetaLayout
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    from lumfuncmcmc_tpu_torch.utils.synth import (
        apply_completeness_cut, make_catalog)
    base = LFConfig()
    cfg = LFConfig(min_comp_frac=0.5, size_ln=21,
                   Flim=base.Flim[:nfields], Omega_0=base.Omega_0[:nfields],
                   survey_fields=base.survey_fields[:nfields])
    cat = apply_completeness_cut(make_catalog(cfg, n_target=400, seed=3),
                                 cfg)
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           field_id=cat["field_id"], device=device,
                           dtype=dtype)
    layout = ThetaLayout.from_config(cfg)
    return cl.make_cuda_lnprob(ctx, layout), layout


class _Recorded:
    """An lnprob that keeps each call's ``(theta, out)`` by reference, as
    the benchmark's ``CallLog`` does, and a copy of each beside it."""

    def __init__(self, fn):
        self.fn, self.kept = fn, []

    def __call__(self, th):
        out = self.fn(th)
        self.kept.append((th, out, th.clone(), out.clone()))
        return out

    def check_unchanged(self):
        for th, out, th0, out0 in self.kept:
            _assert_same_bits((th, out), (th0, out0))


def _eager(monkeypatch):
    """The samplers' half-steps on the eager body, on any device."""
    monkeypatch.setattr(affine, "_half_step", _eager_half_step)
    monkeypatch.setattr(tempering, "_half_step", _eager_half_step)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("thin", [1, 2])
@pytest.mark.parametrize("dtype,nfields", [(torch.float32, 5),
                                           (torch.float64, 2)])
def test_kernels_equal_the_eager_body_over_a_fit(device, monkeypatch, dtype,
                                                 nfields, thin, batch):
    """200 steps of a free-completeness fit (float32 D = 9, float64 D = 6;
    one ensemble, or E = 3 through ``run_ensembles_with_rands``) on one
    draw of randoms, kernels against the eager body: chain, lnp and
    acceptance counts equal bit for bit, one launch of each kernel a
    half-step, no host sync, and every lnprob call's recorded rows and
    values unchanged after the run."""
    nsteps, W = 200, 100
    lnprob, layout = _free_lnprob(device, dtype, nfields)
    assert layout.ndim == 4 + nfields
    from lumfuncmcmc_tpu_torch.models.likelihood import sample_init
    g = torch.Generator(device=device).manual_seed(11)
    pos0 = sample_init(g, layout, W * (batch or 1), dtype=dtype,
                       device=device)
    if batch:
        pos0 = pos0.reshape(batch, W, -1)
        run = affine.run_ensembles_with_rands
    else:
        run = affine.run_with_rands
    rands = affine.draw_rands(g, "stretch", nsteps, pos0)
    lnprob(pos0.reshape(-1, pos0.shape[-1]))    # builds and loads
    torch.cuda.synchronize()

    rec = _Recorded(lnprob)
    before = stretch.stretch_propose.launches, stretch.stretch_accept.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(rec, pos0, rands, nsteps, thin=thin)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (stretch.stretch_propose.launches - before[0],
            stretch.stretch_accept.launches - before[1]) == (2 * nsteps,) * 2
    torch.cuda.synchronize()
    rec.check_unchanged()
    assert len(rec.kept) == 1 + 2 * nsteps
    assert any(bool(torch.isinf(out).any()) for _, out, _, _ in rec.kept)

    _eager(monkeypatch)
    want = run(lnprob, pos0, rands, nsteps, thin=thin)
    assert stretch.stretch_propose.launches - before[0] == 2 * nsteps
    _assert_same_bits(got, want)
    acc = got[3]
    assert 0 < float(acc.sum()) < nsteps * acc.numel()
    assert bool((~torch.isfinite(got[2])).sum() == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("a", [2.0, 1.7, 2.5, 3.0])
def test_half_step_equals_the_eager_body_at_any_scale(device, monkeypatch,
                                                      dtype, a):
    """One half-step of E = 4 ensembles at stretch scales whose reciprocal
    is inexact, proposals' lnp from a fixed table holding -inf, NaN and
    values around the moving walkers' (so every branch of the accept
    test is taken): kernels and eager body give the same bits."""
    g = torch.Generator(device=device).manual_seed(5)
    E, nh, D = 4, 50, 7
    x = torch.randn((E, 2 * nh, D), generator=g, device=device, dtype=dtype)
    u_z, j, ln_u = (t[0][0] for t in affine._stretch_rands(
        g, 1, nh, dtype, device, (E,)))
    lnp = torch.randn((E, 2 * nh), generator=g, device=device, dtype=dtype)
    table = lnp[:, nh:] + torch.randn((E, nh), generator=g, device=device,
                                      dtype=dtype)
    table[:, :5] = -torch.inf
    table[:, 5:8] = torch.nan
    args = ((u_z, j, ln_u), x[:, nh:], lnp[:, nh:], x[:, :nh],
            lambda th: table.clone(), a, D)
    n0 = stretch.stretch_accept.launches
    got = affine._half_step(*args)
    assert stretch.stretch_accept.launches == n0 + 1
    _eager(monkeypatch)
    want = affine._half_step(*args)
    _assert_same_bits(got, want)
    assert 0 < int(got[2].sum()) < E * nh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ladder_takes_the_kernels_with_the_eager_bits(device, monkeypatch,
                                                      dtype):
    """The tempered ladder's half-steps (K rungs, per-rung randoms as
    strided views) take the kernels, one launch each, with the eager
    body's chains, lnl and acceptances."""
    nsteps = 30
    lnprob, layout = _free_lnprob(device, dtype, 5)
    from lumfuncmcmc_tpu_torch.models.likelihood import sample_init
    g = torch.Generator(device=device).manual_seed(3)
    K, W = 4, 32
    pos0 = sample_init(g, layout, K * W, dtype=dtype,
                       device=device).reshape(K, W, -1)
    betas = tempering.beta_ladder(K)
    rands = tempering.ladder_rands(g, K, nsteps, W, layout.ndim, dtype,
                                   device)

    def prior(th):
        return torch.zeros_like(th[:, 0])

    n0 = stretch.stretch_propose.launches
    got = tempering.run_tempered_with(prior, lnprob, pos0, betas, rands,
                                      nsteps)
    assert stretch.stretch_propose.launches == n0 + 2 * nsteps
    _eager(monkeypatch)
    want = tempering.run_tempered_with(prior, lnprob, pos0, betas, rands,
                                       nsteps)
    _assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lnprob_float64", "walkers_float16"])
def test_card_refuses_operands_the_kernels_do_not_take(device, case):
    """On the card a half-step whose lnprob returns another dtype than the
    walkers', or whose walkers are float16, raises; it never runs the
    eager body in the kernels' place."""
    g = torch.Generator(device=device).manual_seed(9)
    dt = torch.float16 if case == "walkers_float16" else torch.float32
    nh, D = 50, 4
    x = torch.randn((2 * nh, D), generator=g, device=device).to(dt)
    u_z, j, ln_u = (t[0][0] for t in affine._stretch_rands(
        g, 1, nh, dt, device))
    lnp = torch.zeros(2 * nh, device=device, dtype=dt)

    def lnprob(th):
        return torch.zeros(th.shape[:-1], dtype=torch.float64,
                           device=device)

    n0 = stretch.stretch_accept.launches
    with pytest.raises(TypeError, match="stretch kernels"):
        affine._half_step((u_z, j, ln_u), x[nh:], lnp[nh:], x[:nh], lnprob,
                          2.0, D)
    assert stretch.stretch_accept.launches == n0
