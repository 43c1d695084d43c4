"""CLI entry point of the port: ``python -m lumfuncmcmc_tpu_torch
{fit,fitz,fith,vmax,compare-ic,stack-ic}``.

``fit`` (the single-epoch Schechter fit), ``fitz`` (the
redshift-evolving one), ``fith`` (the hierarchical multi-field one),
``vmax`` (the standalone 1/V_eff pipeline) and the model comparison over
``--ic`` artifacts (``compare-ic``, ``stack-ic``) take the JAX CLI's
arguments, so the same command line works with either package.

A fit runs on a grid of ranks, one process and one card a rank, when it
is launched by ``torchrun`` or given ``--distributed host:port,N,pid``
(NCCL on the cards, gloo with ``--device cpu``); the process group is
joined before anything else and left when the command returns.
"""

from __future__ import annotations

import argparse
import sys

import torch

from lumfuncmcmc_tpu_torch.cli.common import _add_common_flags
from lumfuncmcmc_tpu_torch.cli.fit import cmd_fit, cmd_fith, cmd_fitz
from lumfuncmcmc_tpu_torch.cli.ic_cmds import cmd_compare_ic, cmd_stack_ic
from lumfuncmcmc_tpu_torch.cli.vmax import cmd_vmax
from lumfuncmcmc_tpu_torch.utils.logging import setup_logging


def _add_device_flag(p):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the fit runs: the first CUDA card "
                        "(default; an error when there is none) or "
                        "the CPU")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="lumfuncmcmc_tpu_torch",
        description="luminosity-function inference, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)

    p_fit = sub.add_parser("fit", help="single-epoch Schechter MCMC fit")
    _add_common_flags(p_fit)
    p_fit.add_argument("-fc", "--fix_comp", action="store_true",
                       default=None)
    p_fit.add_argument("-sr", "--same_rand", action="store_true")
    _add_device_flag(p_fit)
    p_fit.set_defaults(func=cmd_fit)

    p_fitz = sub.add_parser("fitz", help="redshift-evolving Schechter fit")
    _add_common_flags(p_fitz)
    _add_device_flag(p_fitz)
    p_fitz.set_defaults(func=cmd_fitz)

    p_fith = sub.add_parser(
        "fith", help="hierarchical multi-field joint fit")
    _add_common_flags(p_fith)
    _add_device_flag(p_fith)
    p_fith.set_defaults(func=cmd_fith)

    p_cmp = sub.add_parser(
        "compare-ic",
        help="paired elpd comparison of two --ic runs on the same catalog "
             "(reads the ic_pointwise_*.npz artifacts)")
    p_cmp.add_argument("npz_a", type=str, help="ic_pointwise npz of model A")
    p_cmp.add_argument("npz_b", type=str, help="ic_pointwise npz of model B")
    p_cmp.set_defaults(func=cmd_compare_ic)

    p_stk = sub.add_parser(
        "stack-ic",
        help="stacking weights for model averaging from K --ic runs on the "
             "same catalog (Yao et al. 2018)")
    p_stk.add_argument("npz", type=str, nargs="+",
                       help="ic_pointwise npz artifacts (>= 2)")
    p_stk.set_defaults(func=cmd_stack_ic)

    p_vmax = sub.add_parser("vmax", help="standalone 1/V_eff pipeline")
    _add_common_flags(p_vmax)
    p_vmax.add_argument("--zbins", type=int, default=1)
    p_vmax.add_argument("--integ", action="store_true")
    p_vmax.add_argument("--linear", action="store_true",
                        help="linear-luminosity pipeline (default is the "
                             "log pipeline)")
    p_vmax.add_argument("--correct-low", dest="correct_low",
                        action="store_true",
                        help="partial-bin completeness correction of the "
                             "faintest bins")
    p_vmax.add_argument("--img-dir", dest="img_dir", type=str,
                        default="ImageFiles")
    p_vmax.add_argument("--mcf-scan", dest="mcf_scan", type=str,
                        default=None, metavar="LO,HI,N",
                        help="scan min_comp_frac over N values and write "
                             "the (alpha, L*) vs mcf parameter-space "
                             "scatter")
    _add_device_flag(p_vmax)
    p_vmax.set_defaults(func=cmd_vmax)

    args = parser.parse_args(argv)
    if (int(getattr(args, "evidence_tune", 0) or 0)
            and not int(getattr(args, "evidence_swap", 0) or 0)):
        # at argument-handling time, not after the whole fit has run
        parser.error("--evidence-tune needs --evidence-swap M (the "
                     "ladder is tuned from measured swap rates)")
    if getattr(args, "same_rand", False):
        args.diff_rand = False
    setup_logging()
    joined = _join_process_group(args)
    try:
        return args.func(args)
    finally:
        if joined:
            from lumfuncmcmc_tpu_torch.parallel.distributed import shutdown
            shutdown()


FIT_COMMANDS = ("fit", "fitz", "fith")


def _join_process_group(args) -> bool:
    """Join the ranks' process group of ``--distributed`` or of a
    ``torchrun`` launch (fits only): NCCL on the cards, gloo with
    ``--device cpu``; no backend stands in for another. Returns whether
    this call joined it (a process already in a group keeps it)."""
    import torch.distributed as dist

    from lumfuncmcmc_tpu_torch.parallel import distributed as pd
    spec = getattr(args, "distributed", None)
    if args.command not in FIT_COMMANDS:
        if spec:
            raise SystemExit("--distributed applies to fit, fitz and fith")
        return False
    if dist.is_initialized():
        if spec:
            raise SystemExit("--distributed: this process is already in a "
                             "process group")
        return False
    if not (spec or pd.launched_by_torchrun()):
        return False
    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "no usable CUDA device (torch.cuda.is_available() is False) for "
            "the ranks' NCCL group; pass --device cpu to run the ranks on "
            "the CPU over gloo")
    if spec:
        pd.init_distributed(*pd.parse_distributed_spec(spec),
                            backend=backend)
    else:
        pd.init_from_env(backend=backend)
    setup_logging().info("Process group: rank %d of %d (%s)"
                         % (pd.rank(), pd.world_size(), backend))
    return True


if __name__ == "__main__":
    sys.exit(main())
