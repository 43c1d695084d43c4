"""PyTorch port vs JAX package: the posterior predictive check
(``models/ppc.py``).

Same contexts and draws on both sides (float64): ``predicted_counts``
for every family at rtol 1e-10 (the segment sum in another order); the
check's edges, observed counts and ``rate_mean`` at rtol 1e-10, and its
bands and p-values equal (the same numpy generator calls draw the same
posterior rows and Poisson scatter from those rates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu.models import ppc as jppc
from lumfuncmcmc_tpu_torch.models import ppc as tppc
from tests.torch_mc_cases import FAMILIES, case, central, posterior

torch.set_num_threads(2)


@pytest.mark.parametrize("fam", FAMILIES)
def test_predicted_counts_match_jax(fam):
    c = case(fam)
    lum = np.asarray(c.jctx.lum)
    edges = np.linspace(lum.min() - 1e-9, lum.max() + 1e-9, 21)
    th = central(c.play, 5, seed=2)
    want = np.asarray(jax.vmap(lambda t: jppc.predicted_counts(
        t, c.jctx, c.jlay, jnp.asarray(edges)))(jnp.asarray(th)))
    got = tppc.predicted_counts(torch.as_tensor(th), c.pctx, c.play, edges)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("fam", FAMILIES)
def test_posterior_predictive_check_matches_jax(fam):
    c = case(fam)
    samples = posterior(fam)
    want = jppc.posterior_predictive_check(samples, c.jctx, c.jlay,
                                           nbins=15, ndraws=120, seed=3)
    got = tppc.posterior_predictive_check(samples, c.pctx, c.play,
                                          nbins=15, ndraws=120, seed=3)
    for k in ("centers", "edges", "rate_mean", "total_predicted"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)
    for k in ("observed", "pred_p16", "pred_p50", "pred_p84", "pvalue",
              "total_observed"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_plot_ppc_writes_the_png(tmp_path):
    pytest.importorskip("matplotlib")
    c = case("fixed")
    ppc = tppc.posterior_predictive_check(posterior("fixed"), c.pctx, c.play,
                                          ndraws=40)
    out = tppc.plot_ppc(ppc, str(tmp_path / "ppc.png"))
    assert (tmp_path / "ppc.png").stat().st_size > 0 and out.endswith(".png")
