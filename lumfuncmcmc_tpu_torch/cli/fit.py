"""The MCMC fit subcommands (port of ``cmd_fit`` / ``cmd_fitz`` /
``cmd_fith`` / ``_run_fit_family`` / ``_dispatch_sampler`` from
``lumfuncmcmc_tpu/cli/fit.py``):

- ``fit``  — single-epoch Schechter fit, into ``LFMCMCOut/``
- ``fitz`` — redshift-evolving fit, into ``LFMCMCzOut/``
- ``fith`` — hierarchical multi-field fit, into ``LFMCMCHOut/``

each with the stretch/DE/mix ensemble or, with ``--sampler nuts``,
batched NUTS, the long-run drivers (``--min-ess``, ``--checkpoint-every``
with resume, ``--ensembles``, ``--profile``), and the post-fit analyses
``--ic``, ``--ppc``, ``--evidence`` and ``--map``.

On a grid of ranks (``--mesh-walkers``/``--mesh-sources``, a
``torchrun`` launch or ``--distributed``) every rank runs the same
program, so every collective (the sampler's lnprob, the evidence ladder,
a resume decision) is called by every rank in the same order, and rank 0
alone writes artifacts, plots and the profiler's trace. ``--sampler
nuts`` there takes the route JAX takes for the same command line
(``models/nuts_driver.py nuts_route``), and ``--nuts-pooled`` pools the
per-rank replicas' step-size and mass adaptation.
"""

from __future__ import annotations

import contextlib
import os

from lumfuncmcmc_tpu_torch.cli.common import (
    _align_fields, _apply_precision, _build_cfg, _load_inputs, _pivot_z)
from lumfuncmcmc_tpu_torch.cli.outputs import (
    _map_only_outputs, _resume_if_done, _resumed_outputs, _run_evidence,
    _write_evidence, _write_ic, _write_outputs, _write_ppc)
from lumfuncmcmc_tpu_torch.parallel.distributed import is_primary
from lumfuncmcmc_tpu_torch.utils.io import artifact_path


def _profiler(outdir):
    """``--profile DIR``: a ``torch.profiler`` trace of the sampler (host
    and, on the card, device activities), exported into DIR."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)

    def export(prof):
        path = os.path.join(outdir, "fit_trace.json")
        prof.export_chrome_trace(path)
        print(f"Profiler trace written to {path}")

    return profile(activities=acts, on_trace_ready=export)


def _dispatch_sampler(model, cfg, args, outdir):
    """NUTS, replicated ensembles (with or without ``--min-ess``),
    ``--min-ess`` blocks, or the plain fit, each checkpointed under
    ``--checkpoint-every`` into its own artifact kind and resumed when
    that file exists; ``--nchains`` is validated either way, and the run
    is traced under ``--profile``, as in the JAX CLI."""
    ens = int(getattr(args, "ensembles", None) or 0)
    min_ess = getattr(args, "min_ess", None)
    nchains = getattr(args, "nchains", None)
    nchains = 8 if nchains is None else int(nchains)
    if nchains < 1:
        raise SystemExit(f"--nchains must be >= 1, got {nchains}")

    def ckpt(kind):
        return (artifact_path(outdir, kind, args.output_filename, cfg,
                              ext="npz") if cfg.checkpoint_every else None)

    def resume(ck):
        return bool(ck and os.path.exists(ck))

    prof = (_profiler(args.profile)
            if getattr(args, "profile", None) and is_primary()
            else contextlib.nullcontext())
    with prof:
        if cfg.sampler == "nuts":
            if ens > 1:
                print("WARNING: --ensembles applies to the ensemble "
                      "sampler; ignored under --sampler nuts")
            ck = ckpt("checkpoint_nuts")
            model.fit_model_nuts(
                nchains=nchains,
                pooled=True if getattr(args, "nuts_pooled", False) else None,
                min_ess=float(min_ess) if min_ess else None,
                checkpoint_path=ck, resume=resume(ck))
        elif ens > 1 and min_ess:
            ck = ckpt("checkpoint_ens_until")
            model.fit_model_ensembles(ens, min_ess=float(min_ess),
                                      checkpoint_path=ck, resume=resume(ck))
        elif ens > 1:
            ck = ckpt("checkpoint_ens")
            model.fit_model_ensembles(ens, checkpoint_path=ck,
                                      resume=resume(ck))
        elif min_ess:
            if cfg.thin > 1:
                print("WARNING: --thin is ignored under --min-ess")
            # the blocks are cfg.nsteps long and the ESS test re-decides
            # after each: the block is the save cadence
            ck = ckpt("checkpoint_until")
            model.fit_model_until(float(min_ess), checkpoint_path=ck,
                                  resume=resume(ck))
        else:
            ck = ckpt("checkpoint")
            model.fit_model(checkpoint_path=ck, resume=resume(ck))


def _run_fit_family(args, model_cls, outdir, z_variant=False, pivot=False):
    """Build config + model, the resume-and-replot early exit (with the
    analyses a rerun asks for), the ``--map`` early exit, the sampler,
    the evidence ladder, then the artifact writers."""
    args.output_filename = args.output_filename or "test.dat"
    cfg = _build_cfg(args)
    if pivot:
        cfg = _pivot_z(cfg, args.filename)
    device, dtype = _apply_precision(cfg, getattr(args, "device", "cuda"))
    if is_primary():
        os.makedirs(outdir, exist_ok=True)
    inputs = _load_inputs(args, cfg)
    cfg = _align_fields(cfg, inputs["field_names"])
    print("Read Input File")
    model = model_cls(cfg, z=inputs["z"], flux=inputs["flux"],
                      flux_e=inputs["flux_e"], lum=inputs["lum"],
                      lum_e=inputs["lum_e"],
                      field_id=inputs["field_id"],
                      field_names=inputs["field_names"],
                      device=device, dtype=dtype)
    print(f"Initialized {model_cls.__name__}")
    if model.grid is not None and model.grid.idle:
        print(f"Rank {model.grid.rank} sits idle: the grid "
              f"{model.grid.shape} uses {model.grid.size} of "
              f"{model.grid.world} ranks")
        return 0
    if _resume_if_done(model, cfg, args, outdir):
        _resumed_outputs(model, cfg, args, outdir)
        return 0
    names = model.get_param_names()
    print("Labels:", names)
    if getattr(args, "map", False):
        return _map_only_outputs(model, cfg, args, outdir)
    _dispatch_sampler(model, cfg, args, outdir)
    # collective: every rank runs the ladder, rank 0 writes
    ev = (_run_evidence(model, args)
          if getattr(args, "evidence", None) is not None else None)
    if not is_primary():
        print("Non-primary rank: artifacts written by rank 0")
        return 0
    print("Finished fitting model and about to create outputs")
    _write_outputs(model, cfg, args, outdir, names, z_variant=z_variant)
    if getattr(args, "ppc", False):
        _write_ppc(model, cfg, args, outdir)
    if getattr(args, "ic", False):
        _write_ic(model, cfg, args, outdir)
    if ev is not None:
        _write_evidence(ev, cfg, args, outdir)
    return 0


def cmd_fit(args):
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
    return _run_fit_family(args, LumFuncModel, "LFMCMCOut")


def cmd_fitz(args):
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModelZ
    return _run_fit_family(args, LumFuncModelZ, "LFMCMCzOut",
                           z_variant=True, pivot=True)


def cmd_fith(args):
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModelH
    return _run_fit_family(args, LumFuncModelH, "LFMCMCHOut")
