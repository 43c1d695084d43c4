"""PyTorch port vs JAX package: NUTS.

JAX's ``_nuts_step`` draws its numbers from a key; the port's takes them
pre-drawn (``NutsRands``). ``_jax_draws`` makes exactly JAX's draws from
the same keys, so both transitions run on identical numbers and must
agree to rounding: 1e-10 on a 2-D Gaussian, 1e-8 on a small LF posterior
(leapfrog error grows over up to 2^8 steps). A short ``run_nuts`` (both
warmup stages and the sampling phase) is compared the same way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.samplers import nuts as jnuts
from lumfuncmcmc_tpu_torch.samplers import nuts as tnuts

torch.set_num_threads(2)
COV = np.array([[1.0, 0.9], [0.9, 1.0]])
PREC = np.linalg.inv(COV)                    # rho = 0.9 Gaussian


def _jax_lnp(y):
    return -0.5 * y @ jnp.asarray(PREC) @ y


def _torch_lnp(y):
    return -0.5 * torch.einsum("ci,ij,cj->c", y, torch.as_tensor(PREC), y)


@functools.partial(jax.jit, static_argnames=("ndim", "md"))
def _jax_draws(keys, ndim, md):
    """The numbers JAX's ``_nuts_step`` draws from each key of ``keys``:
    ``(p0, go_right, u_take, u_sub)`` with leading axis len(keys)."""
    def one(key):
        k_mom, k_dir = jax.random.split(key)
        p0 = jax.random.normal(k_mom, (ndim,), dtype=jnp.float64)

        def doubling(key, _):
            key, k_d, k_swap, k_b = jax.random.split(key, 4)

            def leapfrog(ks, _):
                ks, k = jax.random.split(ks)
                return ks, jax.random.uniform(k, dtype=jnp.float64)

            _, u = jax.lax.scan(leapfrog, k_swap, None, length=2 ** (md - 1))
            return key, (jax.random.bernoulli(k_d), u,
                         jax.random.uniform(k_b, dtype=jnp.float64))

        _, (go, u, us) = jax.lax.scan(doubling, k_dir, None, length=md)
        return p0, go, u, us

    return jax.vmap(one)(keys)


def _rands(keys, ndim, md=8):
    p0, go, u, us = (np.array(a) for a in _jax_draws(keys, ndim, md))
    return tnuts.NutsRands(torch.as_tensor(p0), torch.as_tensor(go),
                           torch.as_tensor(u), torch.as_tensor(us))


def _compare_step(jax_lnp_y, torch_lnp_y, y0, eps, seed, rtol):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(y0))
    step = jax.jit(jax.vmap(
        lambda e, k, y: jnuts._nuts_step(jax.value_and_grad(jax_lnp_y), 8,
                                         e, k, y)))
    want = [np.asarray(a) for a in step(jnp.asarray(eps), keys,
                                        jnp.asarray(y0))]
    rands = _rands(keys, y0.shape[1])
    counts = tnuts.NutsCounts()
    got = tnuts._nuts_step(tnuts.value_and_grad(torch_lnp_y), 8,
                           torch.as_tensor(eps), rands, torch.as_tensor(y0),
                           counts)
    got = [g.numpy() for g in got]
    for name, g, w in zip(("y", "v", "accept_stat"), got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3])
    # both directions open a trajectory, some lanes diverge and some not
    go = rands.go_right[:, 0].numpy()
    assert go.any() and not go.all()
    assert want[3].any() and not want[3].all()
    assert counts.transitions == 1 and counts.leapfrogs >= 1
    return counts


def test_transition_matches_jax_on_a_correlated_gaussian():
    rng = np.random.default_rng(1)
    y0 = rng.normal(size=(12, 2))
    # stable steps up to 2/sqrt(10) ~ 0.63; 2.5 and 3.0 diverge
    eps = np.array([0.01, 0.1, 0.2, 0.3, 0.4, 0.5, 0.15, 0.25, 2.5, 0.35,
                    3.0, 0.02])
    counts = _compare_step(_jax_lnp, _torch_lnp, y0, eps, seed=0,
                           rtol=1e-10)
    assert counts.max_leapfrogs >= 32        # long trees were compared


@functools.lru_cache(maxsize=None)
def _lf_setup():
    from lumfuncmcmc_tpu.config import LFConfig
    from lumfuncmcmc_tpu.models import likelihood as jlik
    from lumfuncmcmc_tpu.models.context import build_context as jax_build
    from lumfuncmcmc_tpu.utils.synth import (
        apply_completeness_cut, make_catalog)
    from lumfuncmcmc_tpu_torch.cosmology import COSMO_FIELDS
    from lumfuncmcmc_tpu_torch.models import likelihood as tlik
    from lumfuncmcmc_tpu_torch.models.context import (
        CTX_FIELDS, context_from_arrays)

    cfg = LFConfig(min_comp_frac=0.5, size_ln=21)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=250, seed=11),
                                 cfg)
    _, jctx = jax_build(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(jctx, f)) for f in CTX_FIELDS
              if f != "cosmo"}
    arrays["cosmo"] = {k: np.asarray(getattr(jctx.cosmo, k))
                       for k in COSMO_FIELDS}
    ctx = context_from_arrays(arrays, "cpu", torch.float64)
    jl = jlik.ThetaLayout.from_config(cfg)
    tl = tlik.ThetaLayout.from_config(cfg)
    jlnp_y, _, jto_y = jnuts.make_unconstrained(
        jlik.make_lnprob(jctx, jl), jnp.asarray(jl.lo), jnp.asarray(jl.hi))
    lo, hi = tl.bounds_arrays(torch.float64, "cpu")
    tlnp_y, _, _ = tnuts.make_unconstrained(tlik.make_lnprob(ctx, tl),
                                            lo, hi)
    return cfg, jl, jlnp_y, jto_y, tlnp_y


def test_transition_matches_jax_on_the_lf_posterior():
    cfg, jl, jlnp_y, jto_y, tlnp_y = _lf_setup()
    rng = np.random.default_rng(2)
    lo, hi = np.asarray(jl.lo), np.asarray(jl.hi)
    center = np.array([42.5, -3.0, -1.5, *cfg.Flim, cfg.alpha])
    th = center + 0.01 * (hi - lo) * rng.normal(size=(8, jl.ndim))
    y0 = np.array(jax.vmap(jto_y)(jnp.asarray(th)))
    eps = np.array([0.004, 0.01, 0.02, 0.006, 0.03, 0.015, 1.0, 0.008])
    _compare_step(jlnp_y, tlnp_y, y0, eps, seed=3, rtol=1e-8)


def test_short_run_matches_jax_run_nuts():
    """Two warmup stages (40 transitions: the mass-adaptation branch)
    and 20 samples of 2 chains, fed JAX's numbers phase by phase."""
    nchains, nwarm, nsamp = 2, 40, 20
    key = jax.random.PRNGKey(4)
    y0 = np.random.default_rng(5).normal(size=(nchains, 2))
    want = jnuts.run_nuts(_jax_lnp, jnp.asarray(y0), key,
                          num_warmup=nwarm, num_samples=nsamp)
    k_a, k_b, _ = jax.random.split(key, 3)
    per_phase = {
        "a": jax.vmap(lambda k: jax.random.split(k, nchains))(
            jax.random.split(k_a, nwarm // 2)),
        "b": jax.vmap(lambda k: jax.random.split(k, nchains))(
            jax.random.split(k_b, nwarm - nwarm // 2)),
        "s": jnuts.sampling_keys(key, 0, nsamp,
                                 jnp.arange(nchains, dtype=jnp.uint32)),
    }
    rands = {ph: _rands(k.reshape((-1,) + k.shape[2:]), 2)
             for ph, k in per_phase.items()}

    def draw(phase, t):
        sl = slice(t * nchains, (t + 1) * nchains)
        return tnuts.NutsRands(*(a[sl] for a in rands[phase]))

    got = tnuts.run_nuts_with(draw, _torch_lnp, torch.as_tensor(y0),
                              num_warmup=nwarm, num_samples=nsamp)
    for name, g, w in (("samples", got.samples, want[0]),
                       ("lnp", got.lnps, want[1]),
                       ("accept_stat", got.alphas, want[2]),
                       ("eps", got.eps, want[3]),
                       ("div_frac", got.div_frac, want[4])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-10, err_msg=name)
    c = got.counts
    assert c.transitions == nwarm + nsamp
    assert c.transitions <= c.syncs <= c.transitions + c.leapfrogs * 2


def _leapfrog_np(y, p, eps, n, grad):
    """Plain-NumPy leapfrog; the n+1 (y, p) states in integration order."""
    states = [(y.copy(), p.copy())]
    g = grad(y)
    for _ in range(n):
        p_half = p + 0.5 * eps * g
        y = y + eps * p_half
        g = grad(y)
        p = p_half + 0.5 * eps * g
        states.append((y.copy(), p.copy()))
    return states


def _turn(go_right, ya, yb, pa, pb):
    t = [torch.as_tensor(a)[None] for a in (ya, yb, pa, pb)]
    return bool(tnuts._subtree_turn(torch.tensor([go_right]), *t)[0])


def test_subtree_turn_direction_sensitivity():
    """Port of the JAX package's test: healthy short windows are never
    flagged in either direction, and a window's leftward decision
    equals its rightward one."""
    grad = lambda y: -PREC @ y            # noqa: E731
    rng = np.random.default_rng(7)
    for _ in range(200):
        y0 = 0.5 * rng.normal(size=2)
        p0 = rng.normal(size=2)
        p0 *= max(1.0, 0.8 / np.linalg.norm(p0))
        fwd = _leapfrog_np(y0, p0, 0.01, 2, grad)
        (ya, pa), (yb, pb) = fwd[1], fwd[2]
        assert not _turn(True, ya, yb, pa, pb)
        bwd = _leapfrog_np(y0, p0, -0.01, 2, grad)
        (yc, pc), (yd, pd) = bwd[1], bwd[2]
        assert not _turn(False, yc, yd, pc, pd)

        n = int(rng.integers(2, 17))
        eps = float(rng.uniform(0.05, 0.6))
        fwd = _leapfrog_np(y0, p0, eps, n, grad)
        (ya, pa), (yb, pb) = fwd[0], fwd[n]
        right = _turn(True, ya, yb, pa, pb)
        yd, pd = _leapfrog_np(yb.copy(), pb.copy(), -eps, n, grad)[n]
        np.testing.assert_allclose(yd, ya, atol=1e-8)
        np.testing.assert_allclose(pd, pa, atol=1e-8)
        assert _turn(False, yb, yd, pb, pd) == right


def test_unconstrained_transform_roundtrip():
    lo = torch.tensor([-1.0, 0.0], dtype=torch.float64)
    hi = torch.tensor([1.0, 5.0], dtype=torch.float64)
    lnp, to_theta, to_y = tnuts.make_unconstrained(
        lambda th: torch.zeros(th.shape[0], dtype=th.dtype), lo, hi)
    th = torch.tensor([[0.3, 2.0], [-0.9, 4.9]], dtype=torch.float64)
    np.testing.assert_allclose(to_theta(to_y(th)).numpy(), th.numpy(),
                               rtol=1e-6)
    # the log-Jacobian matches the JAX package's
    y = to_y(th)
    jlnp, _, _ = jnuts.make_unconstrained(lambda t: 0.0, jnp.asarray(lo),
                                          jnp.asarray(hi))
    np.testing.assert_allclose(
        lnp(y).numpy(), np.asarray(jax.vmap(jlnp)(jnp.asarray(y.numpy()))),
        rtol=1e-12)


def test_resample_bad_starts():
    """Port of the JAX package's stuck-chain guard test; the good mask
    equals JAX's on the same lnp."""
    def jlnp(y):
        return jnp.where(y[0] > 5.0, -1.0e6, -0.5 * jnp.sum(y * y))

    def tlnp(y):
        return torch.where(y[:, 0] > 5.0, torch.full_like(y[:, 0], -1e6),
                           -0.5 * (y * y).sum(1))

    y0 = np.array([[0.0, 0.0], [1.0, -1.0], [9.0, 2.0], [0.5, 0.5],
                   [7.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    y1, good = tnuts.resample_bad_starts(tlnp, torch.as_tensor(y0), gen)
    _, jgood = jnuts.resample_bad_starts(jlnp, jnp.asarray(y0),
                                         jax.random.PRNGKey(0))
    np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
    np.testing.assert_array_equal(good.numpy(),
                                  [True, True, False, True, False])
    np.testing.assert_array_equal(y1[good].numpy(), y0[good.numpy()])
    lnp1 = tlnp(y1).numpy()
    assert (lnp1 > lnp1.max() - 1000.0).all()
    assert not np.array_equal(y1[2].numpy(), y1[4].numpy())

    y0n = y0.copy()
    y0n[0, 0] = np.nan
    _, good_n = tnuts.resample_bad_starts(tlnp, torch.as_tensor(y0n), gen)
    _, jgood_n = jnuts.resample_bad_starts(jlnp, jnp.asarray(y0n),
                                           jax.random.PRNGKey(0))
    np.testing.assert_array_equal(good_n.numpy(), np.asarray(jgood_n))
    assert not bool(good_n[0])

    y_bad = torch.tensor([[np.nan, 0.0], [np.nan, 1.0]], dtype=torch.float64)
    y2, good2 = tnuts.resample_bad_starts(tlnp, y_bad, gen)
    assert not bool(good2.any())
    np.testing.assert_array_equal(y2.numpy(), y_bad.numpy())


def test_nuts_model_lnprob_column_is_theta_space():
    """The fitposterior Ln Prob column is the theta-space lnprob, not the
    unconstrained density (which carries the logit Jacobian)."""
    from lumfuncmcmc_tpu_torch.config import LFConfig
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
    from lumfuncmcmc_tpu_torch.utils.synth import (
        apply_completeness_cut, make_catalog)

    cfg = LFConfig(min_comp_frac=0.5, fix_comp=True, size_ln=31,
                   nwalkers=8, nsteps=40)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=250, seed=9),
                                 cfg)
    m = LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                     flux_e=cat["flux_e"], field_id=cat["field_id"],
                     device="cpu")
    samples = m.fit_model_nuts(num_warmup=60, nchains=4)
    assert samples.shape == (40 * 4, 4)
    assert m.chain.shape == (40, 4, 3)
    theta = torch.as_tensor(samples[:, :-1])
    recomputed = m._make_scalar_lnprob()(theta).numpy()
    np.testing.assert_allclose(samples[:, -1], recomputed, rtol=1e-8)
    lo, hi = m.layout.bounds_arrays(torch.float64, "cpu")
    lnp_y, _, to_y = tnuts.make_unconstrained(m._make_scalar_lnprob(),
                                              lo, hi)
    assert not np.allclose(lnp_y(to_y(theta)).numpy(), samples[:, -1])
    c = m.nuts_counts
    assert c.transitions == 60 + 40 and c.leapfrogs >= c.transitions
    with pytest.raises(ValueError, match="strictly between"):
        LumFuncModel(cfg.replace(nuts_target_accept=1.0), z=cat["z"],
                     flux=cat["flux"], field_id=cat["field_id"],
                     device="cpu").fit_model_nuts(num_warmup=2)
