"""Controls that a cell's check must find not correct, each run as a
benchmark run is (``harness/runner.py``), with one thing put in the
program's place:

- ``reference``: the plain reference in the precision below the
  configuration's (``run.py --control``: float32 for a float64
  configuration, bfloat16 for a float32 one);
- ``reference_bfloat16``: the plain reference in bfloat16, whatever the
  configuration states;
- ``lnp_float32``: the program itself, each lnp it returns rounded
  through float32, the precision that ``_check_precision`` refuses from
  ``FLOAT32_MAX_SOURCES`` sources on.

    python3 -m portbench.tests.controls --workload mega.stretch \\
        --kind lnp_float32 --seeds 7,8 --seconds 51

prints one JSON line a run (its ``checks`` and ``correct``) and exits 0;
it needs the card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
KINDS = ("reference", "reference_bfloat16", "lnp_float32")


def _round_through_float32(fn):
    """``fn`` with each value rounded to float32 and back."""
    import torch

    def low(theta):
        out = fn(theta)
        return out.to(torch.float32).to(out.dtype)

    for k in ("data", "stream"):
        if hasattr(fn, k):
            setattr(low, k, getattr(fn, k))
    low.engine = getattr(fn, "engine", "?") + "-lnp-float32"
    return low


@contextlib.contextmanager
def _patched(kind):
    """The program or the harness as ``kind`` needs them, restored on
    exit."""
    from portbench.harness import runner
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
    saved_dtypes = dict(runner.CONTROL_DTYPE)
    saved_batch = LumFuncModel.lnprob_batch
    if kind == "reference_bfloat16":
        runner.CONTROL_DTYPE.update(float64="bfloat16", float32="bfloat16")
    elif kind == "lnp_float32":
        def lnprob_batch(self):
            # the model's own callable, rounded once when it is made (the
            # window wraps it again for its record)
            fresh = self._lnprob_batch is None
            fn = saved_batch(self)
            if fresh:
                fn = self._lnprob_batch = _round_through_float32(fn)
            return fn

        LumFuncModel.lnprob_batch = lnprob_batch
    try:
        yield kind != "lnp_float32"
    finally:
        runner.CONTROL_DTYPE.clear()
        runner.CONTROL_DTYPE.update(saved_dtypes)
        LumFuncModel.lnprob_batch = saved_batch


def run_control(root, workload, seed, seconds, kind, device="cuda"):
    """One run of ``workload`` under the control ``kind``: the result
    line's object."""
    from portbench.harness import runner
    with _patched(kind) as reference:
        return runner.run(root, workload, seed, seconds, 0,
                          time.perf_counter(), device=device,
                          control=reference)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", choices=KINDS, required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # run.py's environment (caches in the checkout, one compute thread),
    # set before torch is imported
    import portbench.run  # noqa: F401
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_control(ROOT, args.workload, seed, args.seconds, args.kind)
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "correct": r["correct"],
                          "checks": r["checks"],
                          "sources": r["device"]["sources"],
                          "smi": r["device"]["smi"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
