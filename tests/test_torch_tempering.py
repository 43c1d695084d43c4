"""PyTorch port vs JAX package: the tempered evidence ladder
(``samplers/tempering.py``) and the prior/likelihood split it runs on.

- ``beta_ladder``, ``tune_ladder``, ``barrier_stats``, ``_pair_swap_block``
  / ``_deo_swap`` (given the uniforms) and ``evidence_from_ladder`` on the
  same arrays: rtol 1e-12;
- the rung-batched ``run_tempered_with`` equals K separate
  ``run_with_rands`` runs of each rung's tempered lnprob on the same
  randoms (rtol 1e-12) for stretch, de and mix, with one lnlike call a
  half-step over all rungs and the recompute in ``max_rows`` chunks;
- ``run_parallel_tempering_with``: each round's leg is that ladder run
  from the previous round's exchanged walkers, and each exchange is JAX's
  ``_deo_swap`` applied to the port's own arrays;
- the Gaussian analytic-evidence oracle at ``tests/test_evidence.py``'s
  bars;
- ``make_cuda_prior_like``'s plain path (the CPU's) equals JAX's
  ``_prior_like_fns`` for all four families at rtol 1e-9, the
  hierarchical one without the hyperprior in ``lnlike_fn``, and
  ``make_cuda_lnprob_h`` is bit for bit the sum it was before the split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.models import model as jmodel
from lumfuncmcmc_tpu.samplers import tempering as jt
from lumfuncmcmc_tpu_torch.models.context import context_from_arrays
from lumfuncmcmc_tpu_torch.models.hierarchical import _ln_normal
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.samplers import affine as taff
from lumfuncmcmc_tpu_torch.samplers import tempering as tt
from tests.torch_mc_cases import FAMILIES, _arrays, case, central

torch.set_num_threads(2)
K, W, D, NSTEPS = 4, 16, 3, 12
MU = torch.tensor([0.3, -0.4, 1.0], dtype=torch.float64)
SD = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64)
HALF = 6.0


def _lnprior(th):
    ok = torch.all(th.abs() < HALF, dim=1)
    return torch.where(ok, torch.zeros_like(th[:, 0]),
                       torch.full_like(th[:, 0], -np.inf))


def _lnlike(th):
    return -0.5 * (((th - MU) / SD) ** 2).sum(dim=1)


def test_ladder_tune_barrier_and_estimators_match_jax():
    for n, p in ((3, 5.0), (16, 5.0), (9, 3.0)):
        np.testing.assert_allclose(tt.beta_ladder(n, p),
                                   jt.beta_ladder(n, p), rtol=1e-12)
    rng = np.random.default_rng(1)
    betas = tt.beta_ladder(9)
    for swap in (rng.uniform(size=8), np.ones(8), np.zeros(8),
                 np.r_[0.0, np.ones(7)]):
        np.testing.assert_allclose(tt.tune_ladder(betas, swap),
                                   jt.tune_ladder(betas, swap), rtol=1e-12)
        assert tt.barrier_stats(swap) == jt.barrier_stats(swap)
    tied = np.array([0.0, 0.25, 1.0, 1.0, 1.0])
    np.testing.assert_array_equal(tt.tune_ladder(tied, np.full(4, 0.9)),
                                  jt.tune_ladder(tied, np.full(4, 0.9)))
    with pytest.raises(ValueError, match="at least 3"):
        tt.beta_ladder(2)
    lnls = rng.normal(-50.0, 3.0, size=(9, 40, 8))
    lnls[0, :, 0] = -1e9                   # the prior rung's far corner
    got = tt.evidence_from_ladder(lnls, betas, burn_frac=0.25)
    want = jt.evidence_from_ladder(lnls, betas, burn_frac=0.25)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_pair_swap_and_deo_match_jax():
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(6, 10, 3))
    lnl = rng.normal(-5.0, 3.0, size=(6, 10))
    betas = tt.beta_ladder(6, 2.0)
    u = rng.uniform(size=(5, 10))
    for phase in (0, 1):
        got = tt._deo_swap(torch.as_tensor(pos), torch.as_tensor(lnl),
                           torch.as_tensor(betas), torch.as_tensor(u), phase)
        want = jt._deo_swap(jnp.asarray(pos), jnp.asarray(lnl),
                            jnp.asarray(betas), jnp.asarray(u), phase)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
        assert got[2].any()
    active = np.array([True, False, True, False, True])
    db = np.diff(betas)
    got = tt._pair_swap_block(torch.as_tensor(pos), torch.as_tensor(lnl),
                              torch.as_tensor(db), torch.as_tensor(u),
                              torch.as_tensor(active))
    want = jt._pair_swap_block(jnp.asarray(pos), jnp.asarray(lnl),
                               jnp.asarray(db), jnp.asarray(u),
                               jnp.asarray(active))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def _counting(fn):
    def wrapped(th):
        wrapped.calls += 1
        wrapped.rows.append(th.shape[0])
        return fn(th)
    wrapped.calls, wrapped.rows = 0, []
    return wrapped


def _rung_lnprob(beta):
    def lnprob(th):
        lp, lnl = _lnprior(th), _lnlike(th)
        t = torch.where(torch.tensor(beta > 0), beta * lnl,
                        torch.zeros_like(lnl))
        return torch.where(torch.isfinite(lp), lp + t,
                           torch.full_like(lp, -np.inf))
    return lnprob


def _pos0(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((K, W, D), generator=g, dtype=torch.float64)
            * 2 - 1) * HALF


@pytest.mark.parametrize("move", ["stretch", "de", "mix"])
def test_rung_batched_ladder_equals_separate_runs(move):
    gen = torch.Generator().manual_seed(7)
    rands = tt.ladder_rands(gen, K, NSTEPS, W, D, torch.float64, "cpu",
                            move, de_prob=0.5)
    betas = tt.beta_ladder(K, 2.0)
    pos0 = _pos0()
    like = _counting(_lnlike)
    chains, lnls, acc = tt.run_tempered_with(
        _lnprior, like, pos0, betas, rands, NSTEPS, move=move)
    # one lnlike call for the start, one a half-step over all rungs, then
    # the recompute (one chunk here)
    assert like.calls == 1 + 2 * NSTEPS + 1
    assert like.rows[:2] == [K * W, K * W // 2]
    for k in range(K):
        if move == "mix":
            r = (rands[0], tuple(x[k] for x in rands[1]),
                 tuple(x[k] for x in rands[2]))
        else:
            r = tuple(x[k] for x in rands)
        _, ch, _, a = taff.run_with_rands(_rung_lnprob(betas[k]), pos0[k],
                                          r, NSTEPS, move=move)
        np.testing.assert_allclose(chains[k].numpy(), ch.numpy(),
                                   rtol=1e-12)
        np.testing.assert_array_equal(acc[k].numpy(), a.numpy())
    np.testing.assert_allclose(lnls.numpy(),
                               _lnlike(chains.reshape(-1, D)).reshape(
                                   K, NSTEPS, W).numpy(), rtol=1e-12)
    # the recompute in chunks of max_rows rows
    like = _counting(_lnlike)
    again = tt.recompute_lnl(like, chains, max_rows=50)
    assert like.calls == -(-K * NSTEPS * W // 50)
    np.testing.assert_array_equal(again.numpy(), lnls.numpy())


def test_parallel_tempering_legs_and_swaps_match_jax():
    gen = torch.Generator().manual_seed(11)
    se, rounds = 3, 4
    n = se * rounds
    rands = tt.ladder_rands(gen, K, n, W, D, torch.float64, "cpu", "stretch")
    u = torch.rand((rounds, K - 1, W), generator=gen, dtype=torch.float64)
    betas = tt.beta_ladder(K, 2.0)
    like = _counting(_lnlike)
    pos0 = _pos0(1)
    chains, lnls, acc, swap_frac, swaps = tt.run_parallel_tempering_with(
        _lnprior, like, pos0, betas, rands, u, n, swap_every=se)
    assert like.calls == 1 + 2 * n + 1       # swaps cost no evaluation
    start = pos0
    for r in range(rounds):
        steps = slice(r * se, (r + 1) * se)
        leg, leg_lnl, _ = tt.run_tempered_with(
            _lnprior, _lnlike, start, betas,
            tuple(x[:, steps] for x in rands), se)
        np.testing.assert_allclose(chains[:, steps].numpy(), leg.numpy(),
                                   rtol=1e-12)
        pos_j, _, do_j = jt._deo_swap(
            jnp.asarray(leg[:, -1].numpy()), jnp.asarray(leg_lnl[:, -1]),
            jnp.asarray(betas), jnp.asarray(u[r].numpy()), r % 2)
        np.testing.assert_array_equal(swaps[r].numpy(), np.asarray(do_j))
        start = torch.as_tensor(np.array(pos_j))
    active = [(rounds + (1 if k % 2 == 0 else 0)) // 2 for k in range(K - 1)]
    np.testing.assert_allclose(
        swap_frac, swaps.double().mean(dim=2).sum(dim=0).numpy()
        / np.asarray(active), rtol=1e-12)
    assert swaps.any()
    with pytest.raises(ValueError, match="swap_every"):
        tt.run_parallel_tempering_with(_lnprior, _lnlike, pos0, betas, rands,
                                       u, n, swap_every=0)


def test_gaussian_evidence_matches_analytic():
    """``tests/test_evidence.py``'s oracle and bars, on the port's ladder
    (12 rungs x 64 walkers x 400 steps, 2-d Gaussian in a box)."""
    mu = torch.tensor([0.3, -0.4], dtype=torch.float64)
    sd = torch.tensor([1.0, 0.5], dtype=torch.float64)

    def lnlike(th):
        return -0.5 * (((th - mu) / sd) ** 2).sum(dim=1)

    gen = torch.Generator().manual_seed(0)
    pos0 = (torch.rand((12, 64, 2), generator=gen, dtype=torch.float64)
            * 2 - 1) * HALF
    betas = tt.beta_ladder(12)
    _, lnls, _ = tt.run_tempered(_lnprior, lnlike, pos0, betas, gen, 400)
    ev = tt.evidence_from_ladder(lnls.numpy(), betas)
    lnz_true = float(np.log(2 * np.pi * sd.prod().item())
                     - np.log((2 * HALF) ** 2))
    assert abs(ev["lnz_ss"] - lnz_true) < 0.15, (ev["lnz_ss"], lnz_true)
    assert abs(ev["lnz_ti"] - lnz_true) < 0.6
    assert 0.0 < ev["lnz_ss_err"] < 0.5
    assert abs(ev["lnz_ss"] - lnz_true) < 5.0 * ev["lnz_ss_err"] + 0.05
    e = ev["mean_lnl"]
    assert e[-1] > e[0]
    assert np.all(np.diff(e[len(e) // 2:]) > 0)


_JAX_MODELS = {"free": jmodel.LumFuncModel, "fixed": jmodel.LumFuncModel,
               "z": jmodel.LumFuncModelZ, "hier": jmodel.LumFuncModelH}


@pytest.mark.parametrize("fam", FAMILIES)
def test_prior_like_split_matches_jax(fam):
    c = case(fam)
    cat = c.cat
    jm = _JAX_MODELS[fam](c.jcfg, z=cat["z"], flux=cat["flux"],
                          flux_e=cat["flux_e"], field_id=cat["field_id"])
    jprior, jlike = jm._prior_like_fns()
    pctx = context_from_arrays(_arrays(jm.ctx), "cpu", torch.float64)
    model = {"z": "z", "hier": "hier"}.get(fam, "single")
    prior, like = cl.make_cuda_prior_like(pctx, c.play, model=model)
    assert like.engine == "plain"
    th = central(c.play, 6, seed=4)
    th[-1, 0] = c.play.hi[0] + 1.0                # out of the box
    tth = torch.as_tensor(th)
    want_p = np.asarray(jax.vmap(jprior)(jnp.asarray(th)))
    want_l = np.asarray(jax.vmap(jlike)(jnp.asarray(th)))
    got_p, got_l = prior(tth).numpy(), like(tth).numpy()
    np.testing.assert_allclose(got_p[:-1], want_p[:-1], rtol=1e-9)
    assert got_p[-1] == want_p[-1] == -np.inf
    np.testing.assert_allclose(got_l[:-1], want_l[:-1], rtol=1e-9)
    assert np.isfinite(got_l[-1])      # clamped features; the prior masks
    # the split sums to the lnprob of the hand-kernel engine's plain path
    lnprob = {"z": cl.make_cuda_lnprob_z, "hier": cl.make_cuda_lnprob_h}.get(
        fam, cl.make_cuda_lnprob)(pctx, c.play)
    np.testing.assert_allclose((prior(tth) + like(tth)).numpy()[:-1],
                               lnprob(tth).numpy()[:-1], rtol=1e-12)


def _hier_collapsed_before_split(feats, thetas, data, layout):
    """``_hier_collapsed`` as it read before the prior/likelihood split."""
    th = torch.clamp(thetas.double(), data.lo, data.hi)
    mu_l, sig_l, mu_p, sig_p, _, lstar_f, phistar_f = layout.unpack(th)
    pf = feats[:, 1:].reshape(feats.shape[0], -1, 3)
    lnpart_f = cl._collapsed(*data.ln_sums_f, pf[..., 0], feats[:, :1],
                             pf[..., 1], pf[..., 2])
    hyper = (_ln_normal(lstar_f, mu_l[:, None], sig_l[:, None])
             + _ln_normal(phistar_f, mu_p[:, None], sig_p[:, None]))
    return (lnpart_f + hyper).sum(dim=1)


def test_hier_lnprob_unchanged_bit_for_bit_by_the_split():
    c = case("hier")
    data = cl.prepare_cuda_h_data(c.pctx, c.play, dtype=torch.float64)
    th = torch.as_tensor(central(c.play, 9, seed=5))
    th[-1, 1] = 0.0                                  # sig_L = 0
    feats = cl._features_hier(th, data, c.play, torch.float64)
    assert torch.equal(cl._hier_collapsed(feats, th, data, c.play),
                       _hier_collapsed_before_split(feats, th, data, c.play))
