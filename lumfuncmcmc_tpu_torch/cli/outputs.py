"""Artifact writers and post-fit analyses for ``fit``, ``fitz`` and
``fith`` (port of ``lumfuncmcmc_tpu/cli/outputs.py``).

The artifacts — fitposterior, bestfitLF, VeffLF, the parameters table,
the ``.args`` settings dump and the triangle plot — keep the JAX CLI's
filenames and the fixed_width_two_line format, and an existing
fitposterior file triggers the resume-and-replot behaviour. The
post-fit analyses (``--ppc``, ``--ic``, ``--evidence``, ``--map``)
write the JAX CLI's ``ppc_*``, ``ic_*`` / ``ic_pointwise_*.npz``,
``evidence_*`` and ``map_*`` artifacts. On a grid of ranks the
collectives come first on every rank (the evidence ladder, the resume
decision) and rank 0 alone writes, as the JAX writers' ``is_primary``
gates have it.
"""

from __future__ import annotations

import os
import time

import numpy as np

from lumfuncmcmc_tpu_torch.parallel.distributed import agree, is_primary


def _write_outputs(model, cfg, args, outdir, names, z_variant=False):
    from lumfuncmcmc_tpu_torch.utils.io import (
        artifact_path, write_fixed_width_two_line)
    od = cfg.output_dict

    if od.get("triangle plot"):
        model.triangle_plot(
            artifact_path(outdir, "triangle", args.output_filename, cfg),
            imgtype=od.get("image format", "png"))
        print("Finished making Triangle Plot with Best-fit LF "
              "(and V_eff-method-based data)")
    else:
        model.set_median_fit()
        print("Finished setting median fit and V_eff parameters")

    full_names = names + ["Ln Prob"]
    if od.get("fitposterior"):
        cols = {nm: model.samples[:, i]
                for i, nm in enumerate(full_names)}
        write_fixed_width_two_line(
            artifact_path(outdir, "fitposterior", args.output_filename,
                          cfg, ext="dat"), cols)
        print("Finished writing fitposterior file")
    if od.get("bestfitLF"):
        if not z_variant:
            cols = {"Luminosity": model.lum,
                    "Luminosity_Err": model.lum_e,
                    "MedianLF": model.medianLF}
        else:
            # the z variant writes the LF matrix alongside its axes
            cols = {"Luminosity_cols": model.Lout,
                    "Redshift_rows": model.zout,
                    **{f"LF_z{i}": model.medianLF[i]
                       for i in range(model.medianLF.shape[0])}}
        write_fixed_width_two_line(
            artifact_path(outdir, "bestfitLF", args.output_filename, cfg,
                          ext="dat"), cols)
        print("Finished writing bestfitLF file")
    if od.get("VeffLF"):
        write_fixed_width_two_line(
            artifact_path(outdir, "VeffLF", args.output_filename, cfg,
                          ext="dat"),
            {"Luminosity": model.Lavg, "BinLF": model.lfbinorig,
             "BinLFErr": np.sqrt(model.var)})
        print("Finished writing VeffLF file")

    # percentile parameters table
    percentiles = list(cfg.param_percentiles)
    labels = ["Line"] + [f"{nm}_{per:02d}" for nm in names
                         for per in percentiles]
    model.table = _SimpleTable(labels)
    model.table.add_row([cfg.line_name] + [0.0] * (len(labels) - 1))
    model.add_fitinfo_to_table(percentiles)
    print(model.table)
    if od.get("parameters"):
        formats = {lab: "%0.3f" for lab in labels}
        formats["Line"] = "%s"
        write_fixed_width_two_line(
            os.path.join(outdir, args.output_filename),
            model.table.as_columns(), formats)
        print("Finished writing LF main table")
    if od.get("settings"):
        with open(os.path.join(outdir,
                               args.output_filename + ".args"), "w") as fh:
            d = dict(vars(args))
            d.pop("log", None)
            fh.write(str(d))
        print("Finished writing settings to file")


class _SimpleTable:
    """Tiny astropy.Table stand-in: ``table[-1][idx] = value`` and
    column export."""

    def __init__(self, labels):
        self.labels = labels
        self.rows = []

    def add_row(self, vals):
        self.rows.append(list(vals))

    def __getitem__(self, i):
        return self.rows[i]

    def __len__(self):
        return len(self.rows)

    def as_columns(self):
        return {lab: [row[i] for row in self.rows]
                for i, lab in enumerate(self.labels)}

    def __str__(self):
        out = [" ".join(self.labels)]
        for row in self.rows:
            out.append(" ".join(str(v) for v in row))
        return "\n".join(out)


def _resume_if_done(model, cfg, args, outdir):
    """An existing fitposterior file: reload it and redraw the plot
    (where matplotlib is installed) instead of sampling again."""
    from lumfuncmcmc_tpu_torch.cli.vmax import _can_plot
    from lumfuncmcmc_tpu_torch.utils.io import (
        artifact_path, read_fixed_width_two_line)
    fn = artifact_path(outdir, "fitposterior", args.output_filename,
                       cfg, ext="dat")
    done = os.path.isfile(fn)
    if model.grid is not None:
        agree([done], f"whether {fn} exists", model.grid.group)
    if not done:
        return False
    tab = read_fixed_width_two_line(fn)
    model.samples = np.column_stack([tab[k] for k in tab])
    if _can_plot() and is_primary():
        model.triangle_plot(
            artifact_path(outdir, "triangle", args.output_filename, cfg),
            imgtype=cfg.output_dict.get("image format", "png"))
    print(f"Resumed from existing {fn}; regenerated plots only")
    return True


def _resumed_outputs(model, cfg, args, outdir):
    """Post-fit analyses on a resumed posterior, so that a rerun adding
    ``--ic``/``--ppc``/``--map``/``--evidence`` to a finished fit runs
    them: the ladder first (every rank), then the MAP, then the writers
    (rank 0)."""
    ev = (_run_evidence(model, args)
          if getattr(args, "evidence", None) is not None else None)
    if getattr(args, "map", False):
        _map_quicklook(model, cfg, args, outdir)
    if not is_primary():
        return
    if getattr(args, "ic", False):
        _write_ic(model, cfg, args, outdir)
    if getattr(args, "ppc", False):
        _write_ppc(model, cfg, args, outdir)
    if ev is not None:
        _write_evidence(ev, cfg, args, outdir)


def _write_ppc(model, cfg, args, outdir):
    """The posterior predictive check on a finer grid than the fit's
    (trapz, at least 201 nodes: whole node weights landing in single
    bins quantize coarse grids' per-bin rates by up to ~5%), rebuilt
    from the catalog on ``model.cfg`` (so the z and hierarchical models'
    fixed completeness carries over)."""
    from lumfuncmcmc_tpu_torch.cli.vmax import _can_plot
    from lumfuncmcmc_tpu_torch.models.ppc import (
        plot_ppc, posterior_predictive_check)
    from lumfuncmcmc_tpu_torch.utils.io import (
        artifact_path, write_fixed_width_two_line)
    if cfg.exact_bounds:
        print("WARNING: --ppc evaluates predicted counts on the frozen "
              "build-time grid; with --exact-bounds the posterior was "
              "sampled under per-theta integration bounds, so faint-bin "
              "predictions can be biased where posterior Flim drifts "
              "from the build-time value")
    ctx_fine = model.rebuild_context(
        model.cfg.replace(size_ln=max(201, model.cfg.size_ln or 0),
                          quadrature="trapz"), model.dtype)
    t0 = time.perf_counter()
    ppc = posterior_predictive_check(model.samples, ctx_fine, model.layout,
                                     nbins=cfg.nbins, seed=cfg.seed)
    model.log.info("Posterior predictive check: %.2f s"
                   % (time.perf_counter() - t0))
    write_fixed_width_two_line(
        artifact_path(outdir, "ppc", args.output_filename, cfg, ext="dat"),
        {"Luminosity": ppc["centers"], "Observed": ppc["observed"],
         "PredMean": ppc["rate_mean"], "Pred16": ppc["pred_p16"],
         "Pred84": ppc["pred_p84"], "PValue": ppc["pvalue"]})
    if _can_plot():
        plot_ppc(ppc, artifact_path(outdir, "ppc", args.output_filename,
                                    cfg, ext="png"))
    print("Finished writing posterior predictive check "
          f"(N_obs={ppc['total_observed']}, "
          f"E[N_pred]={ppc['total_predicted']:.1f})")


def _map_only_outputs(model, cfg, args, outdir):
    """A fresh ``--map`` run: no sampling, so ``--ic``/``--ppc`` cannot
    run (a warning says so); ``--evidence`` needs no posterior and runs
    before the MAP, as on a resumed run."""
    skipped = [f for f in ("ic", "ppc") if getattr(args, f, False)]
    if skipped:
        print("WARNING: --map skips sampling, so "
              + "/".join("--" + f for f in skipped)
              + " cannot run (they need a posterior); rerun without "
              "--map, or rerun with the same output file once a "
              "posterior exists to add them")
    ev = (_run_evidence(model, args)
          if getattr(args, "evidence", None) is not None else None)
    rc = _map_quicklook(model, cfg, args, outdir)
    if ev is not None and is_primary():
        _write_evidence(ev, cfg, args, outdir)
    return rc


def _map_quicklook(model, cfg, args, outdir):
    """``--map``: MAP + Laplace instead of sampling, written as one row
    of ``map_*.dat`` (each parameter and its standard error, ``lnpost``,
    ``lnz_laplace``); every rank fits (no collective), rank 0 writes."""
    from lumfuncmcmc_tpu_torch.utils.io import (
        artifact_path, write_fixed_width_two_line)
    res = model.fit_map()
    if not is_primary():
        return 0
    cols = {}
    se = res["se"]
    for i, nm in enumerate(model.layout.names):
        cols[nm] = np.asarray([res["theta"][i]])
        cols[nm + "_se"] = np.asarray([se[i] if se is not None else np.nan])
    cols["lnpost"] = np.asarray([res["lnpost"]])
    cols["lnz_laplace"] = np.asarray(
        [np.nan if res["lnz_laplace"] is None else res["lnz_laplace"]])
    write_fixed_width_two_line(
        artifact_path(outdir, "map", args.output_filename, cfg, ext="dat"),
        cols)
    if np.asarray(res["boundary"]).any():
        pinned = [nm for nm, b in zip(model.layout.names, res["boundary"])
                  if b]
        print("NOTE: MAP pinned at the prior bound for "
              f"{', '.join(pinned)} — those columns carry no Laplace "
              "error (edge mass is not Gaussian; ln Z integrates the "
              "posterior slice along each pinned axis numerically); "
              "widen the box if they should be free")
    print("Finished writing MAP/Laplace quick-look "
          f"(lnpost={res['lnpost']:.3f}"
          + ("" if res["lnz_laplace"] is None
             else f", Laplace ln Z={res['lnz_laplace']:.3f}") + ")")
    return 0


def _write_ic(model, cfg, args, outdir):
    """WAIC / PSIS-LOO: ``ic_*.dat`` (the scalars) and
    ``ic_pointwise_*.npz`` (the per-source arrays ``compare-ic`` and
    ``stack-ic`` read)."""
    from lumfuncmcmc_tpu_torch.utils.io import (
        artifact_path, write_fixed_width_two_line)
    ic = model.information_criteria(ndraws=int(args.ic_draws))
    write_fixed_width_two_line(
        artifact_path(outdir, "ic", args.output_filename, cfg, ext="dat"),
        {k: np.asarray([ic[k]]) for k in
         ("elpd_waic", "se_waic", "p_waic", "elpd_loo", "se_loo",
          "p_loo", "lppd", "k_max", "frac_k_gt_07", "count_lppd",
          "elpd_waic_total", "n_sources", "ndraws")})
    np.savez(artifact_path(outdir, "ic_pointwise", args.output_filename,
                           cfg, ext="npz"),
             elpd_waic_i=ic["elpd_waic_i"], elpd_loo_i=ic["elpd_loo_i"],
             pareto_k=ic["pareto_k"])
    print("Finished writing information criteria "
          f"(elpd_waic={ic['elpd_waic']:.2f}+-{ic['se_waic']:.2f}, "
          f"elpd_loo={ic['elpd_loo']:.2f}+-{ic['se_loo']:.2f}, "
          f"max Pareto k={ic['k_max']:.2f})")


def _run_evidence(model, args):
    """The tempered-evidence ladder of ``--evidence`` (with
    ``--evidence-swap`` / ``--evidence-tune``): on a grid a COLLECTIVE,
    every rank calls it."""
    swap = int(getattr(args, "evidence_swap", 0) or 0)
    tune = int(getattr(args, "evidence_tune", 0) or 0)
    if tune and not swap:
        raise SystemExit("--evidence-tune needs --evidence-swap M (the "
                         "ladder is tuned from measured swap rates)")
    return model.log_evidence(nrungs=int(args.evidence), swap_every=swap,
                              tune_rounds=tune)


def _write_evidence(ev, cfg, args, outdir):
    """``evidence_*.dat``: the per-rung E_beta[lnlike] curve beside the
    two estimators (replicated per row: one flat table)."""
    from lumfuncmcmc_tpu_torch.utils.io import (
        artifact_path, write_fixed_width_two_line)
    K = int(ev["nrungs"])
    write_fixed_width_two_line(
        artifact_path(outdir, "evidence", args.output_filename, cfg,
                      ext="dat"),
        {"Beta": ev["betas"], "MeanLnL": ev["mean_lnl"],
         "LnZ_SS": np.full(K, ev["lnz_ss"]),
         "LnZ_SS_err": np.full(K, ev["lnz_ss_err"]),
         "LnZ_TI": np.full(K, ev["lnz_ti"]),
         "LnZ_TI_err": np.full(K, ev["lnz_ti_err"])})
    print("Finished writing evidence ladder "
          f"(ln Z = {ev['lnz_ss']:.3f} +- {ev['lnz_ss_err']:.3f} "
          f"stepping-stone, "
          f"{ev['lnz_ti']:.3f} +- {ev['lnz_ti_err']:.3f} TI)")
