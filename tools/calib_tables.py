"""The port's full-size calibration tables on the card: the five example
runs behind the JAX package's ``docs/VALIDATION.md`` sections 7 and 7a,
each in a process of its own, all started together.

    python3 tools/calib_tables.py [OUTDIR]

Runs ``sbc_check 48``, ``coverage_check 40``, ``coverage_check 40
--free --pallas``, ``coverage_check 20 --init-map`` and
``coverage_check_z 30`` (``python -m lumfuncmcmc_tpu_torch.examples.NAME
ARGS``), writes each one's output and log to ``OUTDIR`` (default
``chiprun_out/calib_tables``), and prints the card's name and power
limit, each run's wall and exit code, its tables, and the mean setup and
sampling seconds of its replicates (the calibration module's log lines).
Exits 1 without a card or if a run failed.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (("sbc_check", "48"), ("coverage_check", "40"),
        ("coverage_check", "40", "--free", "--pallas"),
        ("coverage_check", "20", "--init-map"),
        ("coverage_check_z", "30"))
SECONDS = 3000
SPLIT = re.compile(r"replicate \d+: \d+ sources, setup ([\d.]+) s, "
                   r"sampling ([\d.]+) s \((\w+) engine\)")


def main(outdir=None):
    import torch
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    outdir = outdir or os.path.join(ROOT, "chiprun_out", "calib_tables")
    os.makedirs(outdir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = []
    try:
        for run in RUNS:
            stem = "_".join(a.lstrip("-").replace("-", "_") for a in run)
            out = open(os.path.join(outdir, stem + ".txt"), "w+")
            err = open(os.path.join(outdir, stem + ".log"), "w+")
            procs.append((run, out, err, time.perf_counter(),
                          subprocess.Popen(
                              [sys.executable, "-m",
                               f"lumfuncmcmc_tpu_torch.examples.{run[0]}",
                               *run[1:]], stdout=out, stderr=err,
                              cwd=outdir, env=env)))
        deadline = time.monotonic() + SECONDS
        bad = 0
        for run, out, err, t0, proc in procs:
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            wall = time.perf_counter() - t0
            out.seek(0)
            err.seek(0)
            text, log = out.read(), err.read()
            split = [m.groups() for m in SPLIT.finditer(log)]
            engines = sorted({e for _, _, e in split})
            n = max(len(split), 1)
            print(f"\n### {' '.join(run)}: exit {rc}, wall {wall:.1f} s, "
                  f"{len(split)} replicates, mean setup "
                  f"{sum(float(s) for s, _, _ in split) / n:.3f} s, mean "
                  f"sampling {sum(float(r) for _, r, _ in split) / n:.3f} s,"
                  f" engine {engines}")
            print("\n".join(ln for ln in text.splitlines()
                            if not ln.startswith(("replicate ",
                                                  "  replicate "))))
            bad += rc != 0 or engines != ["cuda"]
    finally:
        for _, out, err, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    print(smi)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
