"""The standalone 1/V_eff pipeline subcommand (port of
``lumfuncmcmc_tpu/cli/vmax.py``): the binned LF with bootstrap errors, a
Levenberg-Marquardt Schechter fit and its plot, per equal-count z bin
with ``--zbins``; and the min-completeness-fraction parameter-space scan
(``--mcf-scan``).

The V_eff weights and the bootstrap run on the device the run was given
(the card unless ``--device cpu``); the ~50-point Schechter fit is a host
loop (:mod:`lumfuncmcmc_tpu_torch.models.schfit`).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.cli.common import (
    _apply_precision, _build_cfg, _load_inputs)
from lumfuncmcmc_tpu_torch.cosmology import (
    build_cosmo_arrays, cosmo_table_from_arrays)
from lumfuncmcmc_tpu_torch.models.schfit import fit_schechter
from lumfuncmcmc_tpu_torch.models.veff import (
    apply_partial_bin_correction, binned_lf_bootstrap, equal_count_z_bins,
    linear_bin_edges, log_bin_edges, veff_weights)
from lumfuncmcmc_tpu_torch.ops.completeness import fleming_root_logf_np
from lumfuncmcmc_tpu_torch.ops.omega import LOG10_4PI
from lumfuncmcmc_tpu_torch.utils.io import (
    read_ascii_table, write_fixed_width_two_line)


def _min_flux(cfg, flim, mcf):
    """The flux at which the Fleming completeness is ``mcf``; 0 (no cut)
    for ``mcf`` ~ 0."""
    if mcf <= 1.0e-6:
        return 0.0
    return float(10.0 ** fleming_root_logf_np(
        np.log10(flim), cfg.alpha, float(mcf), cfg.fcmin))


def _veff_cut_and_weights(cfg, flux, z, flim, omega0, mcf, device, dtype):
    """Shared V_eff front half: completeness cut at ``mcf``, cosmology
    table, log-luminosities, per-source 1/V_eff weights, the tensors on
    ``device`` in ``dtype``. Used by the per-z-bin pipeline and the mcf
    scan so the cut/root/weight semantics cannot diverge."""
    root = _min_flux(cfg, flim, mcf)
    keep = flux > root
    fz, zz = flux[keep], z[keep]
    if len(fz) == 0:
        return None
    zmin, zmax = float(zz.min()), float(zz.max())
    cosmo = cosmo_table_from_arrays(build_cosmo_arrays(1.05 * zmax + 0.1),
                                    device, dtype)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    logf = t(np.log10(fz))
    lum = logf + LOG10_4PI + 2.0 * cosmo.log10_dl_cm_at(t(zz))
    log_root = float(np.log10(root)) if root > 0 else -np.inf
    w = veff_weights(logf, lum, torch.full_like(logf, float(np.log10(flim))),
                     torch.full_like(logf, log_root), omega0, zmin, zmax,
                     t(cfg.alpha), cosmo, cfg.fcmin, float(mcf))
    return dict(flux=fz, z=zz, zmin=zmin, zmax=zmax, cosmo=cosmo,
                logf=logf, lum=lum, log_root=log_root, w=w, root=root)


def _bootstrap(cfg, lum, w, edges, log_bins=True):
    """The binned LF and its bootstrap variance as float64 numpy, the
    resamples drawn from ``cfg.seed`` on the tensors' device."""
    gen = torch.Generator(device=lum.device).manual_seed(cfg.seed)
    out = binned_lf_bootstrap(gen, lum, w, edges, cfg.nboot, cfg.nbins,
                              log_bins=log_bins)
    return [a.double().cpu().numpy() for a in out]


def _can_plot():
    """False, with a warning, on a machine without matplotlib: the
    tables are still written."""
    if importlib.util.find_spec("matplotlib") is not None:
        return True
    print("WARNING: matplotlib is not installed; the .dat tables are "
          "written, the plots are skipped")
    return False


def _vmax_mcf_scan(args, cfg, flux, z, flim, omega0, device, dtype):
    """Min-completeness-fraction parameter-space scan: the log V_eff
    pipeline and the Schechter fit at each mcf of the scan, then the
    scatter of (alpha, L*) colored by mcf. Writes the scatter png and a
    .dat table of the scanned fits."""
    from lumfuncmcmc_tpu_torch.utils.plotting import plot_param_space

    try:
        lo_s, hi_s, n_s = args.mcf_scan.split(",")
        lo_v, hi_v, n = float(lo_s), float(hi_s), int(n_s)
    except ValueError:
        raise SystemExit("--mcf-scan expects 'lo,hi,n' (e.g. 0.1,0.9,9)")

    mcfs, als, lss = [], [], []
    for mcf in np.linspace(lo_v, hi_v, n):
        cw = _veff_cut_and_weights(cfg, flux, z, flim, omega0, float(mcf),
                                   device, dtype)
        if cw is None or len(cw["flux"]) < cfg.nbins + 2:
            nkeep = 0 if cw is None else len(cw["flux"])
            print(f"mcf={mcf:.3f}: only {nkeep} sources survive the "
                  "cut; skipped")
            continue
        lavg, lfbin, var = _bootstrap(cfg, cw["lum"], cw["w"],
                                      log_bin_edges(cw["lum"], cfg.nbins))
        fit = fit_schechter(lavg, lfbin, var, name=cfg.line_name,
                            log=True, integ=args.integ)
        mcfs.append(float(mcf))
        als.append(fit.params["al"])
        lss.append(fit.params["Lstar"])
        print(f"mcf={mcf:.3f}: N={len(cw['flux'])} "
              f"alpha={fit.params['al']:.3f} "
              f"Lstar={fit.params['Lstar']:.3f}")
    if not mcfs:
        raise SystemExit("mcf scan produced no usable fits")
    os.makedirs(args.img_dir, exist_ok=True)
    fn = (plot_param_space(mcfs, als, lss, ln=cfg.line_name,
                           lp=cfg.line_plot_name, img_dir=args.img_dir)
          if _can_plot() else "no plot")
    tab_fn = os.path.join(
        args.img_dir, f"al_ls_mcf_scan_{cfg.line_name}.dat")
    write_fixed_width_two_line(
        tab_fn, {"mcf": mcfs, "alpha": als, "Lstar": lss})
    print("Wrote param-space scan:", fn, "and", tab_fn)
    return 0


def cmd_vmax(args):
    """Standalone V_eff pipeline, per equal-count z bin with
    ``--zbins``."""
    from lumfuncmcmc_tpu_torch.utils.plotting import (
        plot_schechter, plot_z_evolution)

    cfg = _build_cfg(args)
    linear = bool(getattr(args, "linear", False))
    if linear and getattr(args, "correct_low", False):
        # mult_factor works in log10-luminosity space; against linear
        # edges it would silently return factor 1
        raise SystemExit("--correct-low is a log-binning feature (the "
                         "reference applies it in getBootErrLog only) — "
                         "drop --linear")
    device, dtype = _apply_precision(cfg, getattr(args, "device", "cuda"))
    if linear and dtype != torch.float64:
        # the linear pipeline leaves log10 space (10**lum ~ 1e42, Lstar
        # bounds up to 1e45): float32 overflows to inf
        dtype = torch.float64
        print("Linear binning: enabling float64 (linear luminosities "
              "overflow float32)")
    if args.synthetic:
        inputs = _load_inputs(args, cfg)
        flux = np.asarray(inputs["flux"]) * 1e-17
        z = np.asarray(inputs["z"])
    else:
        if not args.filename:
            raise SystemExit("either -f FILE or --synthetic N is required")
        tab = read_ascii_table(args.filename)
        flux = np.asarray(tab[f"{cfg.line_name}_flux"]) * 1e-17
        z = np.asarray(tab["z"])
    flim = cfg.Flim[0] * 1e-17
    omega0 = float(np.sum(cfg.Omega_0))
    if getattr(args, "mcf_scan", None):
        return _vmax_mcf_scan(args, cfg, flux, z, flim, omega0, device,
                              dtype)
    keep = flux > _min_flux(cfg, flim, cfg.min_comp_frac)
    flux, z = flux[keep], z[keep]
    if getattr(args, "ppc", False):
        print("WARNING: --ppc needs a posterior; the vmax pipeline "
              "has none — ignored here")
    print("About to start Veff process for", cfg.line_name)
    print("Length of arrays:", len(flux), len(z))

    zbins = max(getattr(args, "zbins", 1) or 1, 1)
    zbin_idx = (equal_count_z_bins(z, zbins) if zbins > 1
                else np.zeros(len(z), dtype=int))
    img_dir = args.img_dir
    sub = "Lin" if linear else "Log"
    plots = _can_plot()
    zevol_results = []
    for b in range(zbins):
        sel = zbin_idx == b
        # the mcf cut is already applied globally (bin membership is
        # defined on the cut catalog); the shared helper re-derives the
        # same root, so the per-bin re-cut is a no-op
        cw = _veff_cut_and_weights(cfg, flux[sel], z[sel], flim, omega0,
                                   cfg.min_comp_frac, device, dtype)
        if cw is None or len(cw["flux"]) < cfg.nbins + 2:
            nkeep = 0 if cw is None else len(cw["flux"])
            print(f"z bin {b}: only {nkeep} sources survive the cut "
                  f"(need > nbins+1 = {cfg.nbins + 1}); skipped")
            continue
        zmin, zmax = cw["zmin"], cw["zmax"]
        cosmo, lum, w = cw["cosmo"], cw["lum"], cw["w"]
        if linear:
            # linear luminosities, edges from the min-flux luminosity at
            # zmax, bins hold sum(phi) (no dL division)
            lum_lin = 10.0 ** lum
            edges = linear_bin_edges(lum_lin, cw["log_root"], zmax, cosmo,
                                     cfg.nbins)
            lavg, lfbin, var = _bootstrap(cfg, lum_lin, w, edges,
                                          log_bins=False)
        else:
            edges = log_bin_edges(lum, cfg.nbins)
            lavg, lfbin, var = _bootstrap(cfg, lum, w, edges)
        if getattr(args, "correct_low", False):
            lfbin, var = apply_partial_bin_correction(
                edges.double().cpu().numpy(), lfbin, var, cw["log_root"],
                zmin, zmax, cosmo)
        print("Finished getting bootstrap-based errors")
        fit = fit_schechter(lavg, lfbin, var, name=cfg.line_name,
                            log=not linear, integ=args.integ)
        print(fit.fit_report())
        name = (args.output_filename or
                f"{cfg.line_name}_Vmax_LF_mcf_"
                f"{int(100 * cfg.min_comp_frac)}_bins_{cfg.nbins}.png")
        if zbins > 1:
            name = f"{name.split('.')[0]}_zbin{b}.png"
        os.makedirs(os.path.join(img_dir, sub), exist_ok=True)
        suffix = "" if linear else "_log"
        write_fixed_width_two_line(
            os.path.join(img_dir, sub,
                         f"{name.split('.')[0]}{suffix}.dat"),
            {"Luminosity": lavg, "BinLF": lfbin,
             "BinLFErr": np.sqrt(var)})
        if plots:
            plot_schechter(lavg, lfbin, var, fit, name, img_dir,
                           log=not linear, integ=args.integ)
        zevol_results.append({"Lavg": lavg, "lfbinorig": lfbin,
                              "var": var, "fit": fit,
                              "zlabel": r"$%.2f < z \leq %.2f$"
                              % (zmin, zmax)})
        print("Finished plotting true luminosity and best-fit "
              "Schechter fit")
    if zbins > 1 and plots:
        fn = plot_z_evolution(zevol_results,
                              args.output_filename or cfg.line_name,
                              img_dir, log=not linear, integ=args.integ)
        print("Wrote z-evolution overlay:", fn)
    return 0
