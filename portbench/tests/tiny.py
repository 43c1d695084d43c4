"""A copy of the benchmark's data at a size the CPU tests can hold: the
same files, with each configuration's catalog, grid and fits cut down.
The harness, the reference and the program are the repository's own."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_CATALOG = {"flagship": 300}
TINY_GRID = {"flagship": 11}
TINY_TRAFFIC = {"stretch": {"nwalkers": 16, "nsteps": 40, "warmup_steps": 8,
                            "check_rows": 64}}
# every folder of files that a cell finds by name
DATA = ("configs", "traffic", "limits", "metrics", "kernel_names", "counts",
        "systems", "drivers", "reference", "catalogs")


def tiny_root(dest: str) -> str:
    """``dest`` holding ``BENCHMARK.json`` and a ``portbench/`` of the
    files found by name (configurations, mixes, limits, metrics, kernel
    names, counts, peaks, and the systems, drivers, references and
    catalog generators they name) at the tiny size. Returns ``dest``."""
    src = os.path.join(REPO, "portbench")
    bench = os.path.join(dest, "portbench")
    for sub in DATA:
        shutil.copytree(os.path.join(src, sub), os.path.join(bench, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(src, "peaks.json"), bench)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    for name, n in TINY_CATALOG.items():
        path = os.path.join(bench, "configs", name + ".json")
        cfg = json.load(open(path))
        cfg["catalog"]["n_target"] = n
        cfg["lfconfig"]["size_ln"] = TINY_GRID[name]
        json.dump(cfg, open(path, "w"))
    for name, over in TINY_TRAFFIC.items():
        path = os.path.join(bench, "traffic", name + ".json")
        t = json.load(open(path))
        t.update(over)
        json.dump(t, open(path, "w"))
    return dest


def run_tiny(root, workload, seed=11, seconds=1.5, trace=0, control=False):
    """One CPU run of a cell of ``root``: the result line's object."""
    import time
    from portbench.harness import runner
    return runner.run(root, workload, seed, seconds, trace,
                      time.perf_counter(), device="cpu", control=control)
