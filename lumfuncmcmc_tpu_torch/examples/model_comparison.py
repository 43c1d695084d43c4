"""Model-comparison walkthrough: every tool the framework offers for
deciding between luminosity-function models, on one synthetic catalog
(port of ``examples/model_comparison.py``).

Compares the single-epoch Schechter fit against the redshift-evolving
model on a catalog GENERATED without evolution, so the right answers
are known: the Bayes factor should not favor the (more flexible) z
model, the paired elpd difference should be a tie or a small win for
the simple model, and stacking should not need the extra flexibility.

Four independent lenses, cheapest first:

1. MAP + Laplace (``fit_map``): seconds; ln Z under the Gaussian
   expansion, trustworthy when the posterior is unimodal.
2. WAIC / PSIS-LOO (``information_criteria``): no extra sampling;
   predictive accuracy from the fit's own draws.
3. Paired elpd (``compare_ic``): the statistically tight comparison;
   per-source elpds are correlated across models on shared data.
4. Tempered evidence (``log_evidence``): the fully Bayesian answer
   (priors included), at the cost of a dedicated multi-rung run.

    python -m lumfuncmcmc_tpu_torch.examples.model_comparison [--device cpu]
"""

import sys

import numpy as np

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.examples import parse_args
from lumfuncmcmc_tpu_torch.models.ic import compare_ic, stacking_weights
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel, LumFuncModelZ
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)


def run(n_target=1200, nwalkers=32, nsteps=400, ndraws=400, nrungs=12,
        evidence_steps=300, swap_every=10, tune_rounds=2, size_ln=None,
        device=None):
    """The four lenses at the JAX script's sizes. Returns the ln Bayes
    factor (single vs z)."""
    kw = {} if size_ln is None else {"size_ln": int(size_ln)}
    cfg = LFConfig(min_comp_frac=0.5, fix_comp=True, quadrature="gauss",
                   Lstar=42.5, phistar=-2.6, sch_al=-1.6,
                   nwalkers=nwalkers, nsteps=nsteps, seed=11, **kw)
    cat = apply_completeness_cut(
        make_catalog(cfg, n_target=n_target, seed=11), cfg)
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"], device=device)

    models = {"single": LumFuncModel(cfg, **kw),
              "z-evol": LumFuncModelZ(cfg, **kw)}

    print("=== 1. MAP + Laplace (seconds) ===")
    for name, m in models.items():
        r = m.fit_map()
        lnz_s = ("unavailable (Hessian not negative definite)"
                 if r["lnz_laplace"] is None
                 else f"{r['lnz_laplace']:.2f}")
        print(f"  {name:7s} lnpost={r['lnpost']:.2f} "
              f"Laplace lnZ={lnz_s}")

    print("=== 2. fit + WAIC / PSIS-LOO (reuses the fit's draws) ===")
    ics = {}
    for name, m in models.items():
        m.fit_model()
        ics[name] = m.information_criteria(ndraws=ndraws)
        print(f"  {name:7s} elpd_loo={ics[name]['elpd_loo']:.2f}"
              f"+-{ics[name]['se_loo']:.2f} "
              f"(p_loo {ics[name]['p_loo']:.1f}, "
              f"max k {ics[name]['k_max']:.2f})")

    print("=== 3. paired elpd difference (the tight comparison) ===")
    r = compare_ic(ics["single"], ics["z-evol"])
    print(f"  elpd(single) - elpd(z) = {r['delta']:+.3f} "
          f"+- {r['se']:.3f} (z={r['z']:+.2f}) -> "
          + {"a": "single preferred", "b": "z-evol preferred",
             "tie": "tie (the simpler model wins by parsimony)"
             }[r["preferred"]])

    w, _ = stacking_weights(np.column_stack(
        [ics["single"]["elpd_loo_i"], ics["z-evol"]["elpd_loo_i"]]))
    print(f"  stacking weights: single={w[0]:.3f} z={w[1]:.3f}")

    print("=== 4. tempered evidence (fully Bayesian; slowest) ===")
    # swap_every: DEO replica exchange (modes flow down the ladder);
    # tune_rounds: short legs re-space the rungs to the measured
    # communication barrier (Syed et al. 2021) before the main run
    lnz = {}
    for name, m in models.items():
        lnz[name] = m.log_evidence(nrungs=nrungs, nsteps=evidence_steps,
                                   swap_every=swap_every,
                                   tune_rounds=tune_rounds)["lnz_ss"]
        print(f"  {name:7s} ln Z = {lnz[name]:.2f}")
    bf = lnz["single"] - lnz["z-evol"]
    print(f"  ln Bayes factor (single vs z) = {bf:+.2f} "
          "(positive favors the simpler model: the z model pays an "
          "Occam penalty for 4 extra parameters the data never asked "
          "for)")
    return bf


def main(argv=None):
    args = parse_args(argv, __doc__)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
