"""Artifact writers for ``fit``, ``fitz`` and ``fith`` (port of
``_write_outputs`` and ``_resume_if_done`` of
``lumfuncmcmc_tpu/cli/outputs.py``).

The artifacts — fitposterior, bestfitLF, VeffLF, the parameters table,
the ``.args`` settings dump and the triangle plot — keep the JAX CLI's
filenames and the fixed_width_two_line format, and an existing
fitposterior file triggers the resume-and-replot behaviour.
"""

from __future__ import annotations

import os

import numpy as np


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
    instead of sampling again."""
    from lumfuncmcmc_tpu_torch.utils.io import (
        artifact_path, read_fixed_width_two_line)
    fn = artifact_path(outdir, "fitposterior", args.output_filename,
                       cfg, ext="dat")
    if not os.path.isfile(fn):
        return False
    tab = read_fixed_width_two_line(fn)
    model.samples = np.column_stack([tab[k] for k in tab])
    model.triangle_plot(
        artifact_path(outdir, "triangle", args.output_filename, cfg),
        imgtype=cfg.output_dict.get("image format", "png"))
    print(f"Resumed from existing {fn}; regenerated plots only")
    return True
