"""Shared CLI plumbing (port of ``lumfuncmcmc_tpu/cli/common.py``): the
common flag set (the JAX CLI's, so the same command line works), config
building, catalog loading and the device/precision policy (the card
unless ``--device cpu``).

Config precedence is CLI > --config file > defaults; a flag value of 0
is not treated as unset.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.config import (
    LFConfig, load_config_file, merge_config)
from lumfuncmcmc_tpu_torch.utils.logging import setup_logging


def _evidence_rungs(s):
    """argparse type for --evidence: fail at parse time, not after the
    whole fit has run (beta_ladder needs >= 3 rungs)."""
    v = int(s)
    if v < 3:
        raise argparse.ArgumentTypeError(
            "--evidence needs at least 3 ladder rungs (beta = 0, "
            "intermediate, 1); omit the flag to skip the evidence run")
    return v


def _accept_frac(s):
    """argparse type for --nuts-target-accept: fail at parse time.
    Out-of-(0,1) targets don't error downstream — they silently wreck
    dual averaging (ta >= 1 drives log_eps to -inf, every transition
    runs to max_doublings and the run crawls; ta <= 0 blows eps up
    into ~100% divergences) and the bad value would be embedded in
    checkpoint fingerprints, poisoning resumes."""
    v = float(s)
    if not 0.0 < v < 1.0:
        raise argparse.ArgumentTypeError(
            "--nuts-target-accept must be strictly between 0 and 1 "
            "(an acceptance-statistic target; Stan's default is 0.8), "
            "got %s" % s)
    return v


def _add_common_flags(p):
    p.add_argument("-f", "--filename", type=str, default=None,
                   help="File to be read for galaxy data")
    p.add_argument("-o", "--output_filename", type=str, default=None,
                   help="Output filename for given run")
    p.add_argument("-nw", "--nwalkers", type=int, default=None)
    p.add_argument("-ns", "--nsteps", type=int, default=None)
    p.add_argument("-nbins", "--nbins", type=int, default=None)
    p.add_argument("-nboot", "--nboot", type=int, default=None)
    p.add_argument("-mcf", "--min_comp_frac", type=float, default=None)
    p.add_argument("-al", "--alpha", type=float, default=None)
    p.add_argument("-fl", "--Flim", type=float, nargs="+", default=None)
    p.add_argument("-sa", "--sch_al", type=float, default=None)
    p.add_argument("-fsa", "--fix_sch_al", action="store_true",
                   default=None)
    p.add_argument("-ln", "--line_name", type=str, default=None)
    p.add_argument("--config", type=str, default=None,
                   help="JSON or configLF-style python config file")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sampler", type=str, default=None,
                   choices=["stretch", "nuts"])
    p.add_argument("--move", type=str, default=None,
                   choices=["stretch", "de", "mix"],
                   help="ensemble proposal for --sampler stretch: "
                        "Goodman-Weare stretch (reference semantics), "
                        "differential evolution, or a 50/50 per-step "
                        "mix (better-mixing option for correlated "
                        "posteriors)")
    p.add_argument("--de-prob", dest="de_prob", type=float, default=None,
                   help="--move mix: fraction of DE steps "
                        "(deterministic schedule; default 0.5 = "
                        "emcee-style equal weighting, flagship optimum "
                        "~0.7)")
    p.add_argument("--size-ln", dest="size_ln", type=int, default=None)
    p.add_argument("--thin", type=int, default=None,
                   help="record every thin-th sampler step")
    p.add_argument("--checkpoint-every", dest="checkpoint_every",
                   type=int, default=None)
    p.add_argument("--mesh-walkers", dest="mesh_walkers", type=int,
                   default=None)
    p.add_argument("--mesh-sources", dest="mesh_sources", type=int,
                   default=None)
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="Use an N-source synthetic catalog instead of -f")
    p.add_argument("--dust-file", dest="dust_file", type=str, default=None,
                   help="Optional dust/E(B-V) table joined on Field+ID "
                        "(the reference hardwired its filename, "
                        "run_lumfuncmcmc.py:241)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="Write a torch.profiler trace of the sampler "
                        "to DIR")
    p.add_argument("--quadrature", type=str, default=None,
                   choices=["trapz", "gauss"],
                   help="trapz = reference parity; gauss = production "
                        "split-panel Gauss-Legendre (default trapz)")
    p.add_argument("--z-param", dest="z_param", type=str, default=None,
                   choices=["pivots", "natural"],
                   help="fitz parameterization: pivot values (reference) "
                        "or value/slope/curvature at z2")
    p.add_argument("--ppc", action="store_true",
                   help="write a posterior predictive check (counts per "
                        "L bin vs the model's Poisson prediction)")
    p.add_argument("--init-map", dest="init_map", action="store_true",
                   default=None,
                   help="start walkers/chains from overdispersed "
                        "Laplace draws around the MAP instead of "
                        "uniform box draws (slashes burn-in; the "
                        "evidence ladder keeps prior-wide starts "
                        "regardless)")
    p.add_argument("--map", action="store_true",
                   help="MAP + Laplace quick-look (fit/fitz/fith): "
                        "multi-start BFGS posterior mode, Hessian "
                        "standard errors, and a Laplace ln Z "
                        "cross-check of --evidence — NO sampling "
                        "(map_*.dat; seconds instead of minutes)")
    p.add_argument("--ic", action="store_true",
                   help="compute WAIC and PSIS-LOO predictive "
                        "information criteria from the fitted posterior "
                        "(no extra sampling; ic_*.dat) — two models' "
                        "elpd difference ranks predictive accuracy")
    p.add_argument("--ic-draws", dest="ic_draws", type=int, default=1000,
                   metavar="S",
                   help="posterior draws used by --ic (default 1000)")
    p.add_argument("--evidence", type=_evidence_rungs, default=None,
                   metavar="K",
                   help="estimate ln Z (marginal likelihood) by "
                        "parallel tempering over a K-rung temperature "
                        "ladder (K >= 3) sampled simultaneously "
                        "(stepping-stone + thermodynamic integration; "
                        "evidence_*.dat); two models' ln Z difference "
                        "is a Bayes factor")
    p.add_argument("--evidence-swap", dest="evidence_swap", type=int,
                   default=0, metavar="M",
                   help="with --evidence: DEO replica-exchange swaps "
                        "between adjacent ladder rungs every M steps "
                        "(true parallel tempering — cold chains "
                        "inherit mode-hopping from the hot rungs; "
                        "composes with a device mesh via ghost-rung "
                        "exchange; 0 = no swaps)")
    p.add_argument("--evidence-tune", dest="evidence_tune", type=int,
                   default=0, metavar="T",
                   help="with --evidence-swap: T short adaptation "
                        "legs before the main run, re-spacing the "
                        "ladder to equalize measured swap rejection "
                        "across pairs (communication-barrier "
                        "schedule, Syed et al. 2021); 0 = fixed "
                        "power-law ladder")
    p.add_argument("--exact-bounds", dest="exact_bounds",
                   action="store_true", default=None,
                   help="free completeness: re-derive the integration "
                        "bound from theta each eval (reference freezes "
                        "it at the build-time parameters)")
    p.add_argument("--use-pallas", dest="use_pallas", action="store_true",
                   default=None,
                   help="force the hand-written CUDA likelihood "
                        "kernels (DEFAULT on a CUDA device; the CPU runs "
                        "their plain PyTorch versions)")
    p.add_argument("--no-pallas", dest="use_pallas", action="store_false",
                   help="force the eager PyTorch likelihood engine")
    p.add_argument("--nchains", type=int, default=None, metavar="C",
                   help="--sampler nuts: number of NUTS chains "
                        "(default 8, must be >= 1; with a device mesh "
                        "the count is rounded to the device/axis "
                        "multiple of the selected path)")
    p.add_argument("--nuts-pooled", dest="nuts_pooled",
                   action="store_true",
                   help="--sampler nuts on a mesh with the native "
                        "gradient kernel: pmean-pool step-size/mass "
                        "adaptation across devices (one shared eps "
                        "from the global chain population) instead of "
                        "independent per-device replicas")
    p.add_argument("--nuts-target-accept", dest="nuts_target_accept",
                   type=_accept_frac, default=None, metavar="A",
                   help="--sampler nuts: dual-averaging target "
                        "acceptance statistic (default 0.8; raise "
                        "toward 0.9-0.99 if divergent transitions "
                        "are reported)")
    p.add_argument("--min-ess", dest="min_ess", type=float, default=None,
                   metavar="N",
                   help="run until every parameter reaches N effective "
                        "samples (convergence-controlled stopping; "
                        "repeats nsteps-sized blocks, max 50) instead "
                        "of a fixed step count")
    p.add_argument("--ensembles", type=int, default=None, metavar="C",
                   help="run C independent replicated ensembles in one "
                        "vmapped program and report the true "
                        "cross-ensemble Gelman-Rubin R-hat (fills the "
                        "chip at small walker counts)")
    p.add_argument("--distributed", type=str, default=None,
                   metavar="HOST:PORT,NPROC,PID",
                   help="join a grid of NPROC ranks, one process and one "
                        "card a rank, as rank PID (rank 0 listens at "
                        "HOST:PORT; torchrun launches need no flag); the "
                        "grid is --mesh-walkers x --mesh-sources, by "
                        "default (NPROC, 1)")


def _build_cfg(args) -> LFConfig:
    overrides = {k: v for k, v in vars(args).items()
                 if k in LFConfig.field_names()}
    if overrides.get("Flim") is not None:
        overrides["Flim"] = tuple(overrides["Flim"])
    file_over = load_config_file(args.config) if args.config else None
    cfg = merge_config(LFConfig(), file_over, overrides)
    # label special-casing applies to the MERGED line name (the reference
    # applies it post-merge too, run_lumfuncmcmc.py:129-132), so a
    # line_name set only in a --config file still gets the right label
    if cfg.line_name == "OIII":
        cfg = cfg.replace(line_plot_name=r"[OIII] $\lambda 5007$")
    elif cfg.line_name == "Ha":
        cfg = cfg.replace(line_plot_name=r"${\rm{H\alpha}}$")
    return cfg


def _pivot_z(cfg: LFConfig, filename) -> LFConfig:
    """Pivot-redshift special cases of the reference's z run script, by
    catalog file name and by line."""
    base = os.path.basename(filename) if filename else ""
    if base == "OIIIGautamWillNoAGN.dat":
        z = (1.20, 1.76, 2.32)
    else:
        z = (1.20, 1.53, 1.86)
    if cfg.line_name == "Ha":
        z = (1.18, 1.36, 1.54)
    return cfg.replace(z1=z[0], z2=z[1], z3=z[2])


def _align_fields(cfg, field_names):
    """Align the per-field config arrays to the catalog's fields.

    By-name matching against cfg.survey_fields when the names are known,
    else positional truncation (see ``io.align_field_params``). With
    fewer unique fields in the data than configured Flim/Omega_0
    entries, the extra entries would enter the Poisson integral as
    surveyed-but-empty fields and bias phistar low (the reference
    crashes in this situation, run_lumfuncmcmc.py:174/defineFlimOmArr).
    Keeping a genuinely surveyed zero-detection field is a library-level
    choice — pass the full arrays to build_context directly for that.
    """
    from lumfuncmcmc_tpu_torch.utils.io import align_field_params
    return align_field_params(cfg, field_names)


def _load_inputs(args, cfg):
    from lumfuncmcmc_tpu_torch.utils.io import read_catalog
    if args.synthetic:
        from lumfuncmcmc_tpu_torch.utils.synth import (
            make_catalog, apply_completeness_cut)
        cat = apply_completeness_cut(
            make_catalog(cfg, n_target=args.synthetic, seed=cfg.seed), cfg)
        return dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
                    lum=None, lum_e=None, field_id=cat["field_id"],
                    field_names=np.asarray(
                        [f"F{i}" for i in range(len(cfg.Flim))]))
    if not args.filename:
        raise SystemExit("either -f FILE or --synthetic N is required")
    cat = read_catalog(args.filename, cfg,
                       dust_fn=getattr(args, "dust_file", None))
    return dict(z=cat["z"], flux=cat.get("flux"),
                flux_e=cat.get("flux_e"), lum=cat.get("lum"),
                lum_e=cat.get("lum_e"), field_id=cat["field_id"],
                field_names=cat["field_names"])


def _apply_precision(cfg, device="cuda"):
    """Choose the run's device and dtype — the one place the port does.

    ``device`` is ``"cuda"`` (the first card, or in a process group this
    rank's, ``cuda:LOCAL_RANK``; the default everywhere) or ``"cpu"``;
    the CPU runs only when asked for. With ``"cuda"`` and no usable card
    this raises: nothing falls back to the CPU. A single process that
    sees several cards uses one and logs how to run on all of them.
    ``cfg.use_x64`` picks the dtype: None means float64 on the CPU
    (accuracy) and float32 on the card (speed). Returns
    ``(device, dtype)`` and logs them.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no usable CUDA device (torch.cuda.is_available() is "
                "False); the port runs on the card unless asked "
                "otherwise: pass --device cpu (device='cpu') to run on "
                "the CPU")
        if device.index is None:
            from lumfuncmcmc_tpu_torch.parallel.distributed import (
                rank_device, world_size)
            device = rank_device(device)
            n = torch.cuda.device_count()
            if n > 1 and world_size() == 1:
                setup_logging().info(
                    "%d cards visible; this process runs on one. A grid "
                    "over all of them is one process a card: torchrun "
                    "--nproc-per-node %d -m lumfuncmcmc_tpu_torch ..."
                    % (n, n))
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use cuda or cpu")
    use = cfg.use_x64
    if use is None:
        use = device.type == "cpu"
    dtype = torch.float64 if use else torch.float32
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    setup_logging().info("Device: %s (%s), dtype %s"
                         % (device, name, str(dtype).replace("torch.", "")))
    return device, dtype
