"""Per-step time breakdown of the PyTorch port's flagship fit on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/profile_torch_fit.py [--steps 1000] [--profile-steps 100]
    python3 tools/profile_torch_fit.py --sampler nuts [--transitions 20]
    python3 tools/profile_torch_fit.py --model z [--sampler nuts]
    python3 tools/profile_torch_fit.py --model hier [--sampler nuts]
    python3 tools/profile_torch_fit.py --mega [--sampler nuts]

The catalog and model are the smoke test's flagship ones (``LFConfig``
defaults with ``min_comp_frac=0.5``: 5 fields, 100 walkers, 2000
synthetic sources, float32 on the card). For each engine and grid it
times ``run_stretch`` on the model's ``lnprob_batch`` (host clock, device
sync at both ends, after warm-up), then the sampler loop alone with a
trivial lnprob, one W=50 lnprob call, and a ``torch.profiler`` trace of
the flagship loop (device time, launches, the kernels' share). With
``--sampler nuts`` it times NUTS instead (8 chains, free completeness,
trapz-101, the value+gradient kernel): ``--transitions`` transitions
with the step size and mass a 100-transition warmup adapts, then two
more under ``torch.profiler`` — ms per value+gradient call, leapfrogs
per transition, the card's busy share and the kernel's device time.
``--model z`` takes the redshift-evolving model instead (``fitz``:
trapz-201, 7-dim theta, the ``z_lnlike`` / ``z_lnlike_vg`` kernels),
``--model hier`` the hierarchical multi-field one (``fith``: trapz-201,
15-dim theta, ``hier_lnlike`` / ``hier_lnlike_vg``). ``--mega`` takes
the mega catalog of ``fit --synthetic 1200000 --seed 7 --quadrature
gauss`` (1,019,385 sources, gauss-32) with a float64 lnprob
(``use_x64``), through the streaming kernels (``free_stream_lnlike`` /
``free_stream_lnlike_vg``); its stretch run sets them beside the resident
``free_lnlike`` at the same shape (no eager engine: its float64 (W, N)
temporaries are ~400 MB each).
Prints one line per measurement and a JSON summary last. Imports only
the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lumfuncmcmc_tpu_torch import LFConfig  # noqa: E402
from lumfuncmcmc_tpu_torch.models.model import (  # noqa: E402
    LumFuncModel, LumFuncModelH, LumFuncModelZ)
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl  # noqa: E402
from lumfuncmcmc_tpu_torch.samplers import nuts  # noqa: E402
from lumfuncmcmc_tpu_torch.samplers.affine import run_stretch  # noqa: E402
from lumfuncmcmc_tpu_torch.utils.synth import (  # noqa: E402
    apply_completeness_cut, make_catalog)

NWALKERS, NSYNTH, WARMUP = 100, 2000, 20
MEGA_TARGET, MEGA_SEED = 1_200_000, 7


MODELS = {"single": LumFuncModel, "z": LumFuncModelZ, "hier": LumFuncModelH}
# the device kernels of each family's main and value+gradient paths
# (hier_lnlike and hier_lnlike_vg are instances of one template, hier_vg)
KERNELS = {"single": ("free_partials", "free_vg"),
           "z": ("z_value", "z_vg"),
           "hier": ("hier_vg", "hier_vg"),
           "stream": ("stream_partials", "stream_vg_partials",
                      "stream_vg_finish", "stream_finish")}


def _model(cfg, cat, dev, kind="single", dtype=torch.float32):
    return MODELS[kind](cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        device=dev, dtype=dtype)


def _loop_seconds(lnprob, pos0, nsteps, dev):
    """Host seconds of ``run_stretch`` over ``nsteps``, synced at both
    ends, after a warm-up run."""
    gen = torch.Generator(device=dev).manual_seed(0)
    run_stretch(lnprob, pos0, gen, WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_stretch(lnprob, pos0, gen, nsteps)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _attr(evt, *names):
    for n in names:
        if hasattr(evt, n):
            return getattr(evt, n)
    return 0.0


def _device_us(prof, names=()):
    """Total self device time (us) of the profiled window, and per kernel
    name in ``names`` its calls and device time (a template's
    instantiations summed under its name)."""
    dev_us, launches, kern = 0.0, 0, {}
    for evt in prof.key_averages():
        if evt.key.startswith("cudaLaunch"):
            launches += evt.count
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue            # host ops also carry their kernels' time
        self_dev = _attr(evt, "self_device_time_total", "self_cuda_time_total")
        dev_us += self_dev
        # "void hier_vg<8, false, 1>(float const*, ...)" -> "hier_vg"
        name = evt.key.split("(")[0].split("<")[0].split()[-1]
        if name in names:
            k = kern.setdefault(name, {"calls": 0, "device_us": 0.0})
            k["calls"] += evt.count
            k["device_us"] += self_dev
    return dev_us, launches, kern


def profile_nuts(cat, dev, smi, transitions, kind, profiled=2,
                 mega=False):
    """NUTS on the card: ``transitions`` transitions of 8 chains with the
    step size and diagonal mass of a 100-transition warmup, timed (host
    clock, synced), then ``profiled`` more under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    cfg = LFConfig(min_comp_frac=0.5, nwalkers=NWALKERS, sampler="nuts",
                   quadrature="gauss" if mega else "trapz")
    dtype = torch.float64 if mega else torch.float32
    model = _model(cfg, cat, dev, kind, dtype)
    lo, hi = model.layout.bounds_arrays(dtype, dev)
    lnp_y, _, to_y = nuts.make_unconstrained(model._nuts_gradient_post(),
                                             lo, hi)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    start = 0.8 * (lo + hi) / 2 + 0.2 * model._initial_positions(gen)[:8]
    warm = nuts.run_nuts(lnp_y, to_y(start), gen, num_warmup=100,
                         num_samples=1)
    scale, eps = warm.scale, warm.eps
    y = warm.samples[-1] / scale
    vg = nuts.value_and_grad(lambda yp: lnp_y(yp * scale))
    draw = nuts.generator_draw(gen, 8, y.shape[1], 8, dtype, dev)
    out = {"card": smi, "mode": "nuts", "model": model.model_kind,
           "mega": mega}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for label, n in (("timed", transitions), ("profiled", profiled)):
        counts = nuts.NutsCounts()
        torch.cuda.synchronize()
        if label == "profiled":
            prof.__enter__()
        t0 = time.perf_counter()
        for t in range(n):
            y, _, _, _ = nuts._nuts_step(vg, 8, eps, draw("s", t), y, counts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if label == "profiled":
            prof.__exit__(None, None, None)
        calls = counts.transitions + counts.leapfrogs
        out[label] = {"transitions": n, "wall_s": wall, "vg_calls": calls,
                      "ms_per_vg_call": wall / calls * 1e3,
                      "leapfrogs_per_transition":
                          counts.leapfrogs / counts.transitions,
                      "host_syncs": counts.syncs}
        print(f"NUTS {label}: {n} transitions, {calls} value+gradient "
              f"calls in {wall:.4f} s ({wall / calls * 1e3:.4f} ms per "
              f"call, {counts.leapfrogs / counts.transitions:.2f} batched "
              f"leapfrogs per transition, step size {float(eps):.4g})",
              flush=True)
    dev_us, launches, kern = _device_us(
        prof, KERNELS["stream" if mega else kind][1:])
    p_wall, p_calls = out["profiled"]["wall_s"], out["profiled"]["vg_calls"]
    unprof = out["timed"]["ms_per_vg_call"] * p_calls / 1e3
    out["profile"] = {
        "device_s": dev_us / 1e6, "busy_profiled": dev_us / 1e6 / p_wall,
        "busy_unprofiled": dev_us / 1e6 / unprof,
        "cudaLaunchKernel": launches,
        "launches_per_vg_call": launches / p_calls, "kernels": kern}
    print(f"NUTS profiler: device time {dev_us / 1e3:.3f} ms over "
          f"{p_calls} value+gradient calls, busy "
          f"{100 * dev_us / 1e6 / p_wall:.2f}% of the profiled wall and "
          f"{100 * dev_us / 1e6 / unprof:.2f}% of the unprofiled one; "
          f"{launches} cudaLaunchKernel calls ({launches / p_calls:.1f} "
          f"per value+gradient call); kernels {kern}")
    print(json.dumps(out))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--profile-steps", type=int, default=100)
    ap.add_argument("--sampler", choices=["stretch", "nuts"],
                    default="stretch")
    ap.add_argument("--transitions", type=int, default=20)
    ap.add_argument("--model", choices=list(MODELS), default="single")
    ap.add_argument("--mega", action="store_true",
                    help="the 1,019,385-source catalog, streaming kernels")
    args = ap.parse_args(argv)
    if args.mega and args.model != "single":
        sys.exit("--mega takes the single-epoch model")
    if not torch.cuda.is_available():
        sys.exit("this profile needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"card: {smi[0] if smi else 'unknown'}; torch {torch.__version__}")

    base = LFConfig(min_comp_frac=0.5, nwalkers=NWALKERS)
    if args.mega:
        base = base.replace(quadrature="gauss")
    cat = apply_completeness_cut(make_catalog(
        base, n_target=MEGA_TARGET if args.mega else NSYNTH,
        seed=MEGA_SEED if args.mega else base.seed), base)
    print(f"catalog: {len(cat['z'])} sources")
    if args.sampler == "nuts":
        return profile_nuts(cat, dev, smi[0] if smi else None,
                            args.transitions, args.model, mega=args.mega)
    kind = args.model
    dtype = torch.float32
    if args.mega:
        dtype = torch.float64
        cases = [("streaming engine, gauss-32 mega",
                  base.replace(use_pallas=True)),
                 ("resident kernel engine, gauss-32 mega",
                  base.replace(use_pallas=True))]
    elif kind != "single":
        cases = [(f"kernel engine, {kind} trapz-201",
                  base.replace(use_pallas=True)),
                 (f"eager engine, {kind} trapz-201",
                  base.replace(use_pallas=False))]
    else:
        cases = [("kernel engine, trapz-101", base.replace(use_pallas=True)),
                 ("eager engine, trapz-101", base.replace(use_pallas=False)),
                 ("kernel engine, gauss-32",
                  base.replace(use_pallas=True, quadrature="gauss")),
                 ("kernel engine, fixed trapz-201",
                  base.replace(use_pallas=True, fix_comp=True)),
                 ("eager engine, fixed trapz-201",
                  base.replace(use_pallas=False, fix_comp=True))]
    out = {"card": smi[0] if smi else None, "steps": args.steps,
           "step_ms": {}}
    flagship = None
    for label, cfg in cases:
        model = _model(cfg, cat, dev, kind, dtype)
        keep = cl.STREAM_MIN_SOURCES
        if label.startswith("resident"):
            cl.STREAM_MIN_SOURCES = 10**12      # the resident kernel
        lnprob = model.lnprob_batch()
        cl.STREAM_MIN_SOURCES = keep
        pos0 = model._initial_positions(
            torch.Generator(device=dev).manual_seed(cfg.seed))
        sec = _loop_seconds(lnprob, pos0, args.steps, dev)
        ms = sec / args.steps * 1e3
        out["step_ms"][label] = ms
        print(f"{label}: {ms:.4f} ms per full step "
              f"({NWALKERS * args.steps / sec:.1f} lnprob evals/s)")
        if flagship is None:
            flagship = (lnprob, pos0)

    lnprob, pos0 = flagship
    trivial = lambda th: -0.5 * (th * th).sum(dim=1)  # noqa: E731
    sec = _loop_seconds(trivial, pos0, args.steps, dev)
    out["loop_only_ms"] = sec / args.steps * 1e3
    print(f"sampler loop alone (trivial Gaussian lnprob): "
          f"{out['loop_only_ms']:.4f} ms per full step")

    half = pos0[:NWALKERS // 2].contiguous()
    for _ in range(10):
        lnprob(half)
    torch.cuda.synchronize()
    ncall = 1000
    t0 = time.perf_counter()
    for _ in range(ncall):
        lnprob(half)
    torch.cuda.synchronize()
    out["lnprob_call_us"] = (time.perf_counter() - t0) / ncall * 1e6
    print(f"one flagship lnprob call (W=50), host-paced: "
          f"{out['lnprob_call_us']:.2f} us")

    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(1)
    run_stretch(lnprob, pos0, gen, WARMUP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_stretch(lnprob, pos0, gen, args.profile_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, launches, kern = _device_us(
        prof, (KERNELS["stream"][0], KERNELS["stream"][3]) if args.mega
        else (KERNELS[kind][0], "finish"))
    unprof = out["step_ms"][cases[0][0]] * args.profile_steps / 1e3
    out["profile"] = {
        "steps": args.profile_steps, "wall_s": wall, "device_s": dev_us / 1e6,
        "busy_profiled": dev_us / 1e6 / wall, "busy_unprofiled":
        dev_us / 1e6 / unprof, "cudaLaunchKernel": launches,
        "kernels": kern}
    print(f"profiler, {args.profile_steps} flagship steps: wall {wall:.4f} s "
          f"(profiler on), device time {dev_us / 1e3:.3f} ms, busy "
          f"{100 * dev_us / 1e6 / wall:.1f}% of the profiled wall and "
          f"{100 * dev_us / 1e6 / unprof:.1f}% of the unprofiled one; "
          f"{launches} cudaLaunchKernel calls; kernels {kern}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
