"""``chip_smoke.py``'s phase 17 (the device grid) alone, on the card, with
every failed gate reported instead of fatal, so that one call shows every
run's numbers.

    python3 tools/grid_phase.py WORKDIR

Runs ``chip_smoke.run_grid`` in this process, its two ``--grid-rank``
processes through this script (``chip_smoke.fail`` patched in each: a
rank with failures exits 1, which the parent reports too), and prints
the failures last; exits 1 if there were any. The full script,
``python3 chip_smoke.py``, is what holds the gates.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

FAILS = []


def _fail(msg):
    print("FAILED (reported):", msg, flush=True)
    FAILS.append(msg)


def _popen(cmd, *a, **kw):
    """The grid's rank processes through this script."""
    if "--grid-rank" in cmd:
        cmd = [sys.executable, os.path.abspath(__file__)] + cmd[
            cmd.index("--grid-rank"):]
    return _POPEN(cmd, *a, **kw)


_POPEN = subprocess.Popen
cs.fail = _fail
cs.subprocess.Popen = _popen


def main(argv):
    if argv[:1] == ["--grid-rank"]:
        cs.grid_rank(int(argv[1]), int(argv[2]), argv[3], argv[4] == "1")
        print("failures:", FAILS, flush=True)
        print(json.dumps({"grid_rank": int(argv[1]),
                          "launches": {k: 0 for k in cs.KERNELS}}))
        return 1 if FAILS else 0
    os.makedirs(argv[0], exist_ok=True)
    cs.run_grid(argv[0], False)
    print("failures:", FAILS)
    return 1 if FAILS else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
