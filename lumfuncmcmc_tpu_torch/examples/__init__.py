"""Example scripts of the port (counterparts of the JAX package's
``examples/``), each run as a module on the card, or on the CPU with
``--device cpu``::

    python -m lumfuncmcmc_tpu_torch.examples.quickstart
    python -m lumfuncmcmc_tpu_torch.examples.coverage_check [K] [--free] [--pallas] [--mix] [--init-map]
    python -m lumfuncmcmc_tpu_torch.examples.coverage_check_z [K] [--natural]
    python -m lumfuncmcmc_tpu_torch.examples.sbc_check [K]
    python -m lumfuncmcmc_tpu_torch.examples.model_comparison

Each keeps its work in a ``run`` function whose sizes are keywords
(defaults: the JAX scripts' own sizes) and prints the JAX script's
tables on stdout; the library's log goes to stderr.
"""

import argparse


def parse_args(argv, doc, replicates=None, flags=()):
    """The examples' command line: ``K`` (when the script takes
    ``replicates``, its default), each of ``flags`` and ``--device``
    (default: the card)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    if replicates is not None:
        p.add_argument("K", nargs="?", type=int, default=replicates,
                       help=f"replicates (default {replicates})")
    for flag, help_ in flags:
        p.add_argument(flag, action="store_true", help=help_)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)
