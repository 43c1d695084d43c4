"""Quickstart: fit a Schechter luminosity function on synthetic data
(port of ``examples/quickstart.py``).

Draws a multi-field catalog from a known Schechter process, fits it with
the stretch-move ensemble AND with NUTS, runs replicated ensembles, the
evidence ladder and WAIC / PSIS-LOO, cross-checks against the 1/V_eff
estimator, and writes a corner plot where matplotlib is installed: a
compact tour of the library API. On the card the fits run through the
hand-written value and value+gradient kernels; ``--device cpu`` runs
the float64 eager engine.

    python -m lumfuncmcmc_tpu_torch.examples.quickstart [--device cpu]
"""

import os
import sys

import numpy as np

from lumfuncmcmc_tpu_torch.config import LFConfig
from lumfuncmcmc_tpu_torch.examples import parse_args
from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
from lumfuncmcmc_tpu_torch.models.schfit import fit_schechter
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

TRUTH = dict(Lstar=42.5, phistar=-2.6, sch_al=-1.6)


def run(n_target=3000, nwalkers=64, nsteps=800, nuts_warmup=300,
        nchains=8, nensembles=4, nrungs=12, evidence_steps=300,
        ndraws=400, size_ln=None, outdir="QuickstartOut", device=None):
    """The tour at the JAX script's sizes (``nsteps``: the stretch steps
    and the NUTS samples). Returns the model."""
    kw = {} if size_ln is None else {"size_ln": int(size_ln)}
    cfg = LFConfig(
        min_comp_frac=0.5,
        fix_comp=True,            # completeness fixed -> 3-parameter fit
        quadrature="gauss",       # split-panel GL-32 production mode
        nwalkers=nwalkers,
        nsteps=nsteps,
        seed=0,
        **TRUTH, **kw,
    )

    cat = apply_completeness_cut(
        make_catalog(cfg, n_target=n_target, seed=1), cfg)
    print(f"synthetic catalog: {len(cat['z'])} sources, "
          f"{len(cfg.Flim)} fields; truth {TRUTH}")

    model = LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                         flux_e=cat["flux_e"], field_id=cat["field_id"],
                         device=device)

    # --- ensemble fit ---
    samples = model.fit_model()
    for i, name in enumerate(["logL*", "logphi*", "alpha"]):
        med = np.median(samples[:, i])
        lo, hi = np.percentile(samples[:, i], [16, 84])
        print(f"  stretch  {name:8s} = {med:7.3f}  (+{hi - med:.3f} "
              f"-{med - lo:.3f})")

    # --- NUTS on the same posterior ---
    samples_n = model.fit_model_nuts(num_warmup=nuts_warmup,
                                     nchains=nchains)
    for i, name in enumerate(["logL*", "logphi*", "alpha"]):
        print(f"  NUTS     {name:8s} = {np.median(samples_n[:, i]):7.3f}")

    # --- independent replicated ensembles + true multi-chain R-hat ---
    # (on a grid of cards, run under torchrun with mesh_walkers set and
    # the ensembles go one or more to a rank)
    model.fit_model_ensembles(nensembles)
    print("  cross-ensemble R-hat:",
          np.round(model.rhat_ensembles, 4))

    # --- marginal likelihood (Bayes-factor model comparison) ---
    # all ladder rungs sample at once; compare another model's lnz_ss
    # on the same catalog to get a Bayes factor
    ev = model.log_evidence(nrungs=nrungs, nsteps=evidence_steps)
    print(f"  ln Z = {ev['lnz_ss']:.2f} (stepping-stone, "
          f"{ev['nrungs']} rungs)")

    # --- WAIC / PSIS-LOO (predictive model comparison, no extra
    # sampling: reuses the posterior draws the fit already produced) ---
    ic = model.information_criteria(ndraws=ndraws)
    print(f"  elpd_waic = {ic['elpd_waic']:.2f} +- {ic['se_waic']:.2f}"
          f"  (p_waic {ic['p_waic']:.1f}, max Pareto k "
          f"{ic['k_max']:.2f})")

    # --- 1/V_eff cross-check + chi^2 Schechter fit to the binned LF ---
    lavg, lfbin, var = model.veff_lf()
    good = lfbin > 0
    fit = fit_schechter(lavg[good], lfbin[good], var[good],
                        name=cfg.line_name, log=True)
    print(fit.fit_report())

    # --- plots + artifacts ---
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("triangle plot skipped: matplotlib is not installed")
        return model
    os.makedirs(outdir, exist_ok=True)
    model.triangle_plot(os.path.join(outdir, "triangle_quickstart"))
    print(f"wrote {outdir}/triangle_quickstart.png")
    return model


def main(argv=None):
    args = parse_args(argv, __doc__)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
