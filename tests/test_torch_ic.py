"""PyTorch port vs JAX package: WAIC / PSIS-LOO (``models/ic.py``).

Both packages get the same inputs (numpy-seeded, float64):

- ``make_pointwise_fns``: ``loglam`` and ``parts`` for every family on
  the same thetas and catalog columns, rtol 1e-9 (sums of ~1e3 terms in
  another order);
- ``gpd_fit_tail``, ``psis_smooth`` (blocked rows, degenerate rows, a
  tied column, the M < 5 branch), ``waic_from_loglik`` and
  ``loo_from_loglik`` on the same (S, C) arrays: rtol 1e-10;
- ``information_criteria`` on the same posterior draws, subsampled by the
  same numpy call: every scalar and the three per-source arrays rtol
  1e-8 (atol 1e-12 for the roundoff-sized ``max_abs_recon_err``), and
  chunk invariance (rtol 1e-12);
- ``compare_ic`` exactly; ``stacking_weights``: the optimum, not the
  iterates (two BFGS line searches): weights atol 1e-5 and ``log_score``
  rtol 1e-8 against a tight scipy oracle and against JAX where JAX's
  BFGS reaches the optimum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from lumfuncmcmc_tpu.models import ic as jic
from lumfuncmcmc_tpu_torch.models import ic as tic
from tests.torch_mc_cases import FAMILIES, case, central, posterior

torch.set_num_threads(2)

COLS = ("lum", "zsrc", "ln_om_src", "logf_src", "omega0_src")


@pytest.mark.parametrize("fam", FAMILIES)
def test_pointwise_fns_match_jax(fam):
    c = case(fam)
    jl, jp = jic.make_pointwise_fns(c.jctx, c.jlay)
    tl, tp = tic.make_pointwise_fns(c.pctx, c.play)
    th = central(c.play, 6, seed=1)
    mask = np.asarray(c.jctx.src_mask) > 0
    cols = [np.asarray(getattr(c.jctx, k))[mask] for k in COLS]
    fid = np.asarray(c.jctx.field_id)[mask]
    want = np.stack([np.asarray(jl(jnp.asarray(t),
                                   *map(jnp.asarray, cols),
                                   jnp.asarray(fid))) for t in th])
    got = tl(torch.as_tensor(th), *map(torch.as_tensor, cols),
             torch.as_tensor(fid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    jparts = [np.asarray([float(jp(jnp.asarray(t))[i]) for t in th])
              for i in (0, 1)]
    for g, w in zip(tp(torch.as_tensor(th)), jparts):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9)


def _tail_rows(rng, C=40, n=95):
    x = np.sort(stats.genpareto.rvs(0.3, scale=1.0, size=(C, n),
                                    random_state=rng), axis=1)
    x[3] = 0.0                     # no spread
    x[7] = 1.0                     # constant positive
    return x


def test_gpd_fit_tail_matches_jax_blocked_and_degenerate(monkeypatch):
    x = _tail_rows(np.random.default_rng(3))
    jxi, jsig = jic.gpd_fit_tail(x)
    for block in (tic.GPD_BLOCK_ELEMS, 95 * 39 * 7):    # one block; 7 rows
        monkeypatch.setattr(tic, "GPD_BLOCK_ELEMS", block)
        xi, sig = (t.numpy() for t in tic.gpd_fit_tail(x))
        np.testing.assert_allclose(xi, jxi, rtol=1e-10)
        np.testing.assert_allclose(sig, jsig, rtol=1e-10)
        assert np.isinf(xi[[3, 7]]).all() and np.isnan(sig[[3, 7]]).all()
    p = np.linspace(0.01, 0.99, 9)
    for xi0 in (0.0, 0.4, -0.2):
        xi_a, sig_a = np.full(5, xi0), np.linspace(0.5, 2.0, 5)
        np.testing.assert_allclose(
            tic._gpd_quantiles(torch.as_tensor(p), torch.as_tensor(xi_a),
                               torch.as_tensor(sig_a)).numpy(),
            jic._gpd_quantiles(p, xi_a, sig_a), rtol=1e-10)


def _loglik(rng, S, C):
    ll = rng.normal(-3.0, 1.0, size=(S, C)) + rng.standard_t(3, (S, C))
    ll[:, 2] = -1.5                # degenerate: every draw equal
    ll[::4, 5] = ll[0, 5]          # ties inside the tail
    return ll


@pytest.mark.parametrize("S", [16, 400])
def test_psis_waic_loo_match_jax(S):
    ll = _loglik(np.random.default_rng(S), S, 30)
    jw, jk = jic.psis_smooth(ll)
    tw, tk = tic.psis_smooth(ll)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tk.numpy(), jk, rtol=1e-10)
    for t, j in zip(tic.waic_from_loglik(ll), jic.waic_from_loglik(ll)):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-10, atol=1e-13)
    for t, j in zip(tic.loo_from_loglik(ll), jic.loo_from_loglik(ll)):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-10)


SCALARS = ("elpd_waic", "p_waic", "se_waic", "elpd_loo", "p_loo", "se_loo",
           "lppd", "k_max", "frac_k_gt_07", "count_lppd", "count_p",
           "elpd_waic_total", "n_sources", "ndraws")


@pytest.mark.parametrize("fam", FAMILIES)
def test_information_criteria_match_jax(fam):
    c = case(fam)
    draws = posterior(fam)[:, :-1]
    want = jic.information_criteria(draws, c.jctx, c.jlay, ndraws=200,
                                    seed=4, chunk=128)
    got = tic.information_criteria(draws, c.pctx, c.play, ndraws=200,
                                   seed=4, chunk=128)
    for k in SCALARS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
    for k in ("elpd_waic_i", "elpd_loo_i", "pareto_k"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
    np.testing.assert_allclose(got["max_abs_recon_err"],
                               want["max_abs_recon_err"], atol=1e-12)
    assert got["max_abs_recon_err"] < 1e-12
    assert tic.format_ic_report(want) == jic.format_ic_report(want)


def test_information_criteria_chunk_invariance():
    c = case("free")
    draws = posterior("free")[:, :-1]
    whole = tic.information_criteria(draws, c.pctx, c.play, ndraws=150,
                                     chunk=8192, theta_batch=64,
                                     return_pointwise=True)
    parts = tic.information_criteria(draws, c.pctx, c.play, ndraws=150,
                                     chunk=37, theta_batch=11,
                                     return_pointwise=True)
    for k in SCALARS + ("elpd_waic_i", "elpd_loo_i", "pareto_k",
                        "pointwise_loglik"):
        np.testing.assert_allclose(parts[k], whole[k], rtol=1e-12,
                                   err_msg=k)


def test_compare_ic_matches_jax_exactly():
    rng = np.random.default_rng(9)
    a = {"elpd_loo_i": rng.normal(-3, 1, 300),
         "elpd_waic_i": rng.normal(-3, 1, 300)}
    b = {k: v + rng.normal(0.05, 0.1, 300) for k, v in a.items()}
    for x, y in ((a, b), (b, a), (a, a)):
        for which in ("loo", "waic"):
            assert tic.compare_ic(x, y, which) == jic.compare_ic(x, y, which)
    with pytest.raises(ValueError, match="same sources"):
        tic.compare_ic(a, {"elpd_loo_i": a["elpd_loo_i"][:-1]})


@pytest.mark.parametrize("k", [2, 3])
def test_stacking_weights_match_jax(k):
    """The optimum, held to a tight scipy BFGS oracle (weights 1e-5,
    score 1e-8) and to JAX: at k = 2 its weights agree to 1e-5; at k = 3
    the objective is flat enough that JAX's BFGS stops ~5e-3 short in
    the weights (1.2e-3 nats of score), so there the port's score must be
    at least JAX's."""
    from scipy.optimize import minimize
    from scipy.special import log_softmax, logsumexp, softmax
    rng = np.random.default_rng(k)
    base = rng.normal(-3.0, 1.0, 300)
    lpd = np.column_stack([base + rng.normal(0.0, s, 300)
                           for s in (0.3, 0.5, 0.8)[:k]])
    best = minimize(lambda a: -logsumexp(lpd + log_softmax(a)[None],
                                         axis=1).sum(),
                    np.zeros(k), method="BFGS", options={"gtol": 1e-12})
    jw, jinfo = jic.stacking_weights(lpd)
    tw, tinfo = tic.stacking_weights(lpd)
    print(f"k={k}: largest weight gap to the scipy optimum: port "
          f"{np.abs(tw - softmax(best.x)).max():.2e}, JAX "
          f"{np.abs(jw - softmax(best.x)).max():.2e}; score below it: port "
          f"{-best.fun - tinfo['log_score']:.2e}, JAX "
          f"{-best.fun - jinfo['log_score']:.2e}")
    np.testing.assert_allclose(tw, softmax(best.x), atol=1e-5)
    np.testing.assert_allclose(tinfo["log_score"], -best.fun, rtol=1e-8)
    if k == 2:
        np.testing.assert_allclose(tw, jw, atol=1e-5)
        np.testing.assert_allclose(tinfo["log_score"], jinfo["log_score"],
                                   rtol=1e-8)
    assert tinfo["log_score"] >= jinfo["log_score"] - 1e-8
    np.testing.assert_allclose(tinfo["log_score_single"],
                               jinfo["log_score_single"], rtol=1e-12)
    np.testing.assert_allclose(tinfo["pseudo_bma"], jinfo["pseudo_bma"],
                               rtol=1e-12)
    assert tinfo["converged"] and jinfo["converged"]
    with pytest.raises(ValueError, match="at least 2"):
        tic.stacking_weights(lpd[:, :1])
