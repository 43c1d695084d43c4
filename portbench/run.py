"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. Set-up makes the catalog from ``--seed``, builds the model, loads (at
a checkout's first run, builds) the kernel library and warms up the
cell's shapes; the window then runs the cell's traffic for ``--seconds``;
the program's output is then compared with the plain float64 reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (``--trace 1``) and last ``checks``, each number compared
beside its limit, which also end standard error.

Exits non-zero, with no result, where the card is missing or too few,
where a module of JAX or of the JAX package was loaded, or where the
program is not beside ``portbench/``. ``--control`` (never used by the
benchmark's runs) puts the reference, in the precision below the
configuration's, in the program's place.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache the run may write stays at a fixed place in the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
for _var, _sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("LUMFUNC_NATIVE_CACHE", "native")):
    os.environ[_var] = os.path.join(CACHE, _sub)
# one process with one compute thread: the loops are paced by the host,
# and idle OpenMP workers spinning beside the launching thread spread the
# rates
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    from portbench.harness import runner
    try:
        result = runner.run(ROOT, args.workload, args.seed, args.seconds,
                            args.trace, T_START, control=args.control)
    except runner.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = runner.forbidden_modules()
    if bad:
        print("portbench: modules of JAX or the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"portbench check {name} = {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
