"""On-card smoke test of the PyTorch/CUDA port (``lumfuncmcmc_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. require CUDA; print the torch/CUDA versions, the card, and
   ``nvidia-smi``'s name and power limit;
2. build the kernels of ``lumfuncmcmc_tpu_torch/csrc`` from source;
3. each kernel against its plain PyTorch version on the card (float32,
   rtol 1e-4) and both against the float64 eager engine (rtol 5e-4), on
   the flagship catalog at trapz-101 and gauss-32 (``free_lnlike``) and
   trapz-201 (``fixed_lnlike``), for walker batches of 50, 100 and 13
   with out-of-box and negative-Flim thetas; kernel and plain times;
4. the port's ``fit`` CLI end to end (100 walkers x 2000 steps on a
   2000-source synthetic catalog), free and fixed completeness: the JAX
   CLI's artifact set, finite Ln Prob, a sane acceptance fraction, and
   launch counters proving the sampler went through the kernels.

Prints the kernel summary as one JSON line, then the device line last.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.cli.main import main as cli_main
from lumfuncmcmc_tpu_torch.models.context import build_context
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, in_box, make_lnprob, sample_init)
from lumfuncmcmc_tpu_torch.ops import _build
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.utils.io import read_fixed_width_two_line
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

RTOL_KERNEL = 1e-4   # f32 sums of <= 2e5 terms in another order
RTOL_F64 = 5e-4      # the JAX package's Pallas-vs-f64 bar
NSTEPS, NWALKERS, NSYNTH = 2000, 100, 2000
KERNEL_SOURCE = "lumfuncmcmc_tpu_torch/csrc/lnlike.cu"
TPU_FILE = "lumfuncmcmc_tpu/ops/pallas_lnlike.py"


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA GPU")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])


def phase_build():
    path = _build.build()
    print(f"kernel build: {_build.build_seconds:.2f} s -> "
          f"{os.path.relpath(path)}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    _build.load_library()


def _device_ms(fn, inner=20, reps=15):
    """Median device time of one ``fn()`` call: ``inner`` calls captured
    in a CUDA graph, replayed ``reps`` times between CUDA events (so the
    host's launch overhead is not in the number)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def _call_ms(fn, inner=50, reps=9):
    """Median stream time per eager call, launch gaps included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def _rel(a, b):
    return float(torch.max(torch.abs(a - b) / torch.abs(b)))


def _central_thetas(cfg, layout, w, gen, dev):
    """``w`` walkers within ~1% of the box width of the catalog's true
    parameters, where a fit spends its steps. Uniform prior draws reach
    |lnL| ~ 1e12, where float32's spacing alone is ~6e4, so the absolute
    error reported for a kernel is taken here."""
    vals = {"Lstar": cfg.Lstar, "phistar": cfg.phistar,
            "sch_al": cfg.sch_al, "alpha": cfg.alpha}
    c = torch.tensor([cfg.Flim[int(n.split("_")[1])]
                      if n.startswith("Flim_") else vals[n]
                      for n in layout.names], dtype=torch.float64,
                     device=dev)
    lo, hi = layout.bounds_arrays(torch.float64, dev)
    th = c + 0.01 * (hi - lo) * torch.randn(
        (w, c.numel()), generator=gen, dtype=torch.float64, device=dev)
    return torch.minimum(torch.maximum(th, lo), hi)


def phase_kernels(dev):
    """Kernel vs plain version vs float64 eager engine on the card."""
    base = LFConfig(min_comp_frac=0.5)
    cat = apply_completeness_cut(
        make_catalog(base, n_target=1000, seed=7), base)
    cases = [("free_lnlike", "trapz-101", base),
             ("free_lnlike", "gauss-32", base.replace(quadrature="gauss")),
             ("fixed_lnlike", "trapz-201", base.replace(fix_comp=True))]
    summary = {}
    for kname, grid, cfg in cases:
        layout = ThetaLayout.from_config(cfg)
        kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
                  field_id=cat["field_id"], device=dev)
        _, ctx32 = build_context(cfg, dtype=torch.float32, **kw)
        _, ctx64 = build_context(cfg, dtype=torch.float64, **kw)
        data = cl.prepare_cuda_data(ctx32, layout.fix_comp, layout.fcmin,
                                    dtype=torch.float32)
        eager64 = make_lnprob(ctx64, layout)
        lo, hi = layout.bounds_arrays(torch.float64, dev)
        kernel = getattr(cl, kname)
        plain = getattr(cl, kname + "_reference")

        def features(th):
            th = cl._clamp_flim(th.float(), layout)
            if layout.fix_comp:
                return cl._features_fixed(th, ctx32, layout, data.lref,
                                          torch.float32)
            return cl._features_free(th, layout, data.lref, data.fcmin,
                                     torch.float32)

        for w in (50, 100, 13):
            gen = torch.Generator(device=dev).manual_seed(1000 + w)
            th = sample_init(gen, layout, w, dtype=torch.float64, device=dev)
            th[0, 0] = layout.hi[0] + 1.0                 # out of box
            if not layout.fix_comp:
                k = 2 if layout.fix_sch_al else 3
                th[1, k] = -1.0                           # negative Flim
            feats = features(th)
            got = kernel(feats, data)
            ref = plain(feats, data)
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
                fail(f"{kname} {grid} W={w}: non-finite raw lnlike")
            err_k = _rel(got, ref)
            ok = in_box(th, lo, hi)
            want = eager64(th)
            fin = torch.isfinite(want)
            if not torch.equal(fin, ok):
                fail(f"{kname} {grid} W={w}: eager -inf pattern is not "
                     "the box mask")
            err_kf = _rel(got.double()[fin], want[fin])
            err_pf = _rel(ref.double()[fin], want[fin])
            print(f"{kname} {grid} W={w}: kernel vs plain max rel "
                  f"{err_k:.3e}; kernel vs f64 eager {err_kf:.3e}; plain "
                  f"vs f64 eager {err_pf:.3e}; -inf rows "
                  f"{int((~fin).sum())}")
            if err_k > RTOL_KERNEL:
                fail(f"{kname} {grid} W={w}: kernel vs plain {err_k:.3e} "
                     f"> {RTOL_KERNEL}")
            if max(err_kf, err_pf) > RTOL_F64:
                fail(f"{kname} {grid} W={w}: vs f64 eager "
                     f"{max(err_kf, err_pf):.3e} > {RTOL_F64}")
            # the whole lnprob path gives the same -inf pattern
            lnp = cl.make_cuda_lnprob(ctx32, layout)(th.float())
            if not torch.equal(torch.isfinite(lnp), fin):
                fail(f"{kname} {grid} W={w}: lnprob -inf pattern differs")
            if w == 50:
                rec = summary.setdefault(kname, {"max_abs_err": 0.0,
                                                 "max_rel_err": 0.0})
                thc = _central_thetas(cfg, layout, w, gen, dev)
                fc = features(thc)
                got_c, ref_c = kernel(fc, data), plain(fc, data)
                want_c = eager64(thc)
                abs_c = float((got_c - ref_c).abs().max())
                err_c = _rel(got_c, ref_c)
                err_cf = _rel(got_c.double(), want_c)
                print(f"{kname} {grid} W=50 near the true parameters: "
                      f"kernel vs plain max abs {abs_c:.3e} (|lnL| <= "
                      f"{float(ref_c.abs().max()):.3e}), max rel "
                      f"{err_c:.3e}; kernel vs f64 eager {err_cf:.3e}")
                if err_c > RTOL_KERNEL or err_cf > RTOL_F64:
                    fail(f"{kname} {grid} near the true parameters: "
                         f"{err_c:.3e} vs plain, {err_cf:.3e} vs f64 eager")
                rec["max_abs_err"] = max(rec["max_abs_err"], abs_c)
                rec["max_rel_err"] = max(rec["max_rel_err"], err_k, err_c)
                ms = _device_ms(lambda: kernel(feats, data))
                pms = _device_ms(lambda: plain(feats, data))
                cms = _call_ms(lambda: kernel(feats, data))
                print(f"{kname} {grid} W=50 device time: kernel "
                      f"{ms * 1e3:.2f} us, plain {pms * 1e3:.2f} us; "
                      f"eager wrapper call {cms * 1e3:.2f} us")
                if grid in ("trapz-101", "trapz-201"):   # flagship shapes
                    rec.update(ms=ms, plain_ms=pms, call_ms=cms,
                               shape=f"W=50, {grid}, "
                                     f"{data.g_a.shape[0]} cells")
    return summary


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def value(self, prefix):
        for line in reversed(self.lines):
            if line.startswith(prefix):
                return float(line[len(prefix):].split()[0])
        fail(f"the fit logged no '{prefix}' line")


def phase_fit(fix_comp, workdir, has_mpl):
    """The port's CLI, end to end, through the kernels."""
    cfg_path = os.path.join(workdir, "smoke_config.json")
    od = dict(LFConfig().output_dict)
    od["triangle plot"] = has_mpl
    with open(cfg_path, "w") as fh:
        json.dump({"output_dict": od}, fh)
    argv = ["fit", "--synthetic", str(NSYNTH), "-mcf", "0.5",
            "-nw", str(NWALKERS), "-ns", str(NSTEPS), "--config", cfg_path]
    if fix_comp:
        argv.append("-fc")
    rec = _Records()
    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    log.addHandler(rec)
    cwd = os.getcwd()
    run_dir = os.path.join(workdir, "fc" if fix_comp else "free")
    os.makedirs(run_dir)
    os.chdir(run_dir)
    try:
        cl.free_lnlike.launches = 0
        cl.fixed_lnlike.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        wall = time.perf_counter() - t0
        counts = {"free_lnlike": cl.free_lnlike.launches,
                  "fixed_lnlike": cl.fixed_lnlike.launches}
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(cwd)
        log.removeHandler(rec)
    label = "fit -fc" if fix_comp else "fit"
    if rc != 0:
        fail(f"{label} returned {rc}")
    base = f"test_nb50_nw{NWALKERS}_ns{NSTEPS}_mcf50"
    out = os.path.join(run_dir, "LFMCMCOut")
    want = [f"fitposterior_{base}.dat", f"bestfitLF_{base}.dat",
            f"VeffLF_{base}.dat", "test.dat", "test.dat.args"]
    if has_mpl:
        want.append(f"triangle_{base}.png")
    missing = [f for f in want if not os.path.isfile(os.path.join(out, f))]
    if missing:
        fail(f"{label}: missing artifacts {missing}")
    post = read_fixed_width_two_line(
        os.path.join(out, f"fitposterior_{base}.dat"))
    lnp = np.asarray(post["Ln Prob"])
    if lnp.size == 0 or not np.all(np.isfinite(lnp)):
        fail(f"{label}: non-finite Ln Prob in fitposterior")
    acc = rec.value("Mean acceptance fraction:")
    if not 0.1 < acc < 0.9:
        fail(f"{label}: acceptance fraction {acc} outside (0.1, 0.9)")
    used = "fixed_lnlike" if fix_comp else "free_lnlike"
    other = "free_lnlike" if fix_comp else "fixed_lnlike"
    if counts[used] != 1 + 2 * NSTEPS or counts[other] != 0:
        fail(f"{label}: launch counts {counts}, expected {used} = "
             f"{1 + 2 * NSTEPS} and {other} = 0")
    lstar = np.median(np.asarray(post[r"$\log L_*$"]))
    print(f"{label}: artifacts ok ({len(lnp)} posterior rows), acceptance "
          f"{acc:.4f}, sampling loop {rec.value('Total time taken:'):.3f} s,"
          f" {rec.value('lnprob evaluations/s:'):.1f} lnprob evals/s, "
          f"device memory peak {peak / 2**20:.1f} MiB, CLI wall "
          f"{wall:.1f} s, {used} launches {counts[used]}, median logL* "
          f"{lstar:.3f}")
    return counts


def main():
    phase_device()
    phase_build()
    summary = phase_kernels(torch.device("cuda:0"))
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    with tempfile.TemporaryDirectory() as workdir:
        launches = {}
        for fix_comp in (False, True):
            for k, v in phase_fit(fix_comp, workdir, has_mpl).items():
                launches[k] = launches.get(k, 0) + v
    if "jax" in sys.modules:
        fail("the port imported jax")
    replaces = {"free_lnlike": (601, 761), "fixed_lnlike": (751, 813)}
    kernels = []
    for name in ("free_lnlike", "fixed_lnlike"):
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_FILE}:{replaces[name][0]}",
            "also_replaces": f"{TPU_FILE}:{replaces[name][1]}",
            "launches": launches[name],
            "max_abs_err": s["max_abs_err"],
            "max_rel_err": s["max_rel_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "call_ms": s["call_ms"],
            "shape": s["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
