"""CLI entry point of the port: ``python -m lumfuncmcmc_tpu_torch
{fit,fitz,fith,vmax}``.

``fit`` (the single-epoch Schechter fit), ``fitz`` (the
redshift-evolving one), ``fith`` (the hierarchical multi-field one) and
``vmax`` (the standalone 1/V_eff pipeline) are ported; they take the JAX
CLI's flag sets, so the same command line works with either package.
The JAX package's other subcommands are listed and answer "not ported
yet".
"""

from __future__ import annotations

import argparse
import sys

from lumfuncmcmc_tpu_torch.cli.common import _add_common_flags
from lumfuncmcmc_tpu_torch.cli.fit import cmd_fit, cmd_fith, cmd_fitz
from lumfuncmcmc_tpu_torch.cli.vmax import cmd_vmax
from lumfuncmcmc_tpu_torch.utils.logging import setup_logging

_NOT_PORTED_COMMANDS = ("compare-ic", "stack-ic")


def _not_ported(args):
    raise SystemExit(f"'{args.command}' is not ported yet (run it with the "
                     "JAX package, lumfuncmcmc_tpu)")


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
    for name in _NOT_PORTED_COMMANDS:
        sub.add_parser(name, help="not ported yet",
                       add_help=False).set_defaults(func=_not_ported)

    args, rest = parser.parse_known_args(argv)
    if args.func is _not_ported:
        _not_ported(args)
    if rest:
        parser.error("unrecognized arguments: " + " ".join(rest))
    if getattr(args, "same_rand", False):
        args.diff_rand = False
    setup_logging()
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
