"""One run of one cell: set-up, the timed window, the comparison with the
reference, and with ``--trace 1`` the per-layer metrics of the traced
slice. Returns the result line's object. Everything that belongs to the
cell's configuration or mix comes from the files it names (``cells.py``);
this file is the same for every cell."""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

from portbench.harness.calls import sync
from portbench.harness.cells import Cell
from portbench.harness.trace import Tracer, breakdown

# what the lower-precision control computes in: the nearest precision
# below the one a configuration states
CONTROL_DTYPE = {"float64": "float32", "float32": "bfloat16"}
FORBIDDEN = ("jax", "jaxlib", "flax", "lumfuncmcmc_tpu")


class NoCard(RuntimeError):
    """No card, or fewer than the cell asks for."""


class RunRecord:
    """What a per-layer metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def log(msg):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's (the whole name compared, so the port passes)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def smi():
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _control(cell, cat, dev):
    """The reference in the program's place, in the precision below the
    configuration's: ``(reference, lnprob)``."""
    import torch
    ref = cell.reference(cat)
    ldt = getattr(torch, CONTROL_DTYPE[cell.config["precision"]["stated"]])
    lowfn = ref.lnprob_fn(ldt, dev)

    def low(theta):
        return lowfn(theta).to(theta.dtype)
    low.engine = "reference-" + str(ldt).replace("torch.", "")
    log(f"control: the reference in {ldt} in the program's place")
    return ref, low


def run(root, workload, seed, seconds, trace, t_start, device="cuda",
        control=False):
    cell = Cell(root, workload)
    import torch
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count()
                                 >= cell.chips):
        raise NoCard(
            f"cell {workload} needs {cell.chips} card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        device)
    system, driver = cell.system, cell.driver
    library = system.load_library(dev)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    cat = cell.catalog(seed)
    if dev.type == "cuda":          # the CUDA context, outside the build
        torch.empty(1, device=dev)
        sync(dev)
    t0 = time.perf_counter()
    model = system.build(cell, cat, device)
    sync(dev)
    context_s = time.perf_counter() - t0
    model_dtype = system.dtype(model)
    log(f"cell {workload} seed {seed}: {card}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {len(cat['z'])} sources, kernel "
        f"library {library}, dtype {model_dtype}")
    ref, low = _control(cell, cat, dev) if control else (None, None)
    driver.warm_up(cell, model, seed, dev, lnprob=low)
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(bool(trace), dev)
    win = driver.window(cell, model, seed, seconds, tracer, lnprob=low)
    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0)
    shapes = system.shapes(model)
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison, once the window has closed and the peak is read
    t_check = time.perf_counter()
    if ref is None:
        ref = cell.reference(cat)
    numbers, compared = driver.check(cell, ref, win, seed, dev)
    check_s = time.perf_counter() - t_check
    log("readings " + json.dumps(numbers))
    checks = {k: {"value": numbers[k], "limit": lim["limit"]}
              for k, lim in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    metrics = {}
    if not trace:
        values = dict(driver.end_to_end(win), setup_s=setup_s)
        for m, _ in cell.metrics(False):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        rec = RunRecord(cell=cell, trace=tracer.result, window=win,
                        log=win["log"], shapes=shapes,
                        counters={"context_build_s": context_s})
        for m, read in cell.metrics(True):
            v = read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": card,
                   "count": cell.chips if dev.type == "cuda" else 0,
                   "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": 0, "metrics": metrics, "device": device_info}
    slice_ = "none"
    if trace and tracer.result is not None:
        device_info["busy_s"] = tracer.result.busy_s()
        device_info["window_s"] = tracer.result.window_s()
        result["breakdown"] = breakdown(tracer.result, driver.LOOP)
        slice_ = "%.3f s, parsed in %.3f s" % (
            tracer.t_stop - tracer.t_start, tracer.parse_s)
    limit = smi() if dev.type == "cuda" else "CPU"
    device_info.update({"smi": limit, "torch": torch.__version__,
                        "cuda": torch.version.cuda,
                        "sources": len(cat["z"]), "library": library,
                        "dtype": model_dtype})
    log(f"card {limit}; window {win['t1'] - win['t0']:.3f} s, "
        f"{win['attempted']} attempted; setup {setup_s:.3f} s (context "
        f"{context_s:.3f} s); check {check_s:.3f} s over {compared} rows; "
        f"traced slice {slice_}")
    result["checks"] = checks
    return result
