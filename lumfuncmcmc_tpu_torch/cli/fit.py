"""The MCMC fit subcommands (port of ``cmd_fit`` / ``cmd_fitz`` /
``cmd_fith`` / ``_run_fit_family`` / ``_dispatch_sampler`` from
``lumfuncmcmc_tpu/cli/fit.py``):

- ``fit``  — single-epoch Schechter fit, into ``LFMCMCOut/``
- ``fitz`` — redshift-evolving fit, into ``LFMCMCzOut/``
- ``fith`` — hierarchical multi-field fit, into ``LFMCMCHOut/``

each with the stretch/DE/mix ensemble or, with ``--sampler nuts``,
batched NUTS, and the post-fit analyses ``--ic``, ``--ppc``,
``--evidence`` and ``--map``.

Flags whose features are not ported yet raise ``NotImplementedError``
naming the flag, before any work starts.
"""

from __future__ import annotations

import os

from lumfuncmcmc_tpu_torch.cli.common import (
    _align_fields, _apply_precision, _build_cfg, _load_inputs, _pivot_z)
from lumfuncmcmc_tpu_torch.cli.outputs import (
    _map_only_outputs, _resume_if_done, _resumed_outputs, _run_evidence,
    _write_evidence, _write_ic, _write_outputs, _write_ppc)

# CLI-only flags (no LFConfig field) -> the value that means "not
# requested"; unported config fields (exact_bounds, meshes,
# checkpoint_every) are refused by the model itself
_NOT_PORTED_FLAGS = {
    "min_ess": None, "ensembles": None, "nuts_pooled": False,
    "profile": None, "distributed": None,
}


def _reject_unported(args, cfg):
    for flag, off in _NOT_PORTED_FLAGS.items():
        if flag == "ensembles" and cfg.sampler == "nuts":
            continue            # ignored with a warning under NUTS
        if getattr(args, flag, off) != off:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet "
                "(run it with the JAX package, lumfuncmcmc_tpu)")


def _dispatch_sampler(model, cfg, args):
    """NUTS or the ensemble sampler; ``--nchains`` is validated either
    way, as in the JAX CLI."""
    nchains = getattr(args, "nchains", None)
    nchains = 8 if nchains is None else int(nchains)
    if nchains < 1:
        raise SystemExit(f"--nchains must be >= 1, got {nchains}")
    if cfg.sampler == "nuts":
        if int(getattr(args, "ensembles", None) or 0) > 1:
            print("WARNING: --ensembles applies to the ensemble "
                  "sampler; ignored under --sampler nuts")
        model.fit_model_nuts(nchains=nchains)
    else:
        model.fit_model()


def _run_fit_family(args, model_cls, outdir, z_variant=False, pivot=False):
    """Build config + model, the resume-and-replot early exit (with the
    analyses a rerun asks for), the ``--map`` early exit, the sampler,
    the evidence ladder, then the artifact writers."""
    args.output_filename = args.output_filename or "test.dat"
    cfg = _build_cfg(args)
    _reject_unported(args, cfg)
    if pivot:
        cfg = _pivot_z(cfg, args.filename)
    device, dtype = _apply_precision(cfg, getattr(args, "device", "cuda"))
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
    if _resume_if_done(model, cfg, args, outdir):
        _resumed_outputs(model, cfg, args, outdir)
        return 0
    names = model.get_param_names()
    print("Labels:", names)
    if getattr(args, "map", False):
        return _map_only_outputs(model, cfg, args, outdir)
    _dispatch_sampler(model, cfg, args)
    ev = (_run_evidence(model, args)
          if getattr(args, "evidence", None) is not None else None)
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
