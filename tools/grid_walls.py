"""Per-rank sampling walls of the device grid, one card a rank (run under
``torchrun`` on a host with N cards).

    torchrun --nproc-per-node 4 tools/grid_walls.py [--steps 1000]
        [--mega-steps 500]
    torchrun --nproc-per-node 4 tools/grid_walls.py --nuts
        [--nuts-warmup 100] [--nuts-steps 100] [--nuts-chains 8]

Every rank joins the process group ``torchrun`` describes (NCCL; gloo
with ``--device cpu``, for a rehearsal on the CPU), then, on
``chip_smoke.py``'s catalogs and through the library API
(``fit_model``):

- the flagship ``fit`` (100 walkers, ``chip_smoke.py``'s 2000-source
  catalog, the value kernels) on a (1,1) grid of rank 0 alone (the others
  idle: the meshless baseline) and on the (N,1) grid;
- the mega catalog (1,019,385 sources, ``use_x64``, the streaming kernels)
  on (1,1) and on the (1,N) grid, sources dealt round-robin;

each with the sampling wall, the host seconds inside the sharded lnprob's
collectives (``all_gather``/``all_reduce``, device waits included), the
device memory peak of ``fit_model`` and the launch counts. With ``--nuts``
instead: the flagship ``fit --sampler nuts`` (``fit_model_nuts``, the
free model's value+gradient kernel) on (1,1) and as per-rank replicas on
(N,1), each rank adapting alone and pooled, each with its sampling wall,
its value+gradient calls (transitions + leapfrog steps) and ms a call on
this rank, and the run's min ESS and min ESS a second. Prints one line a
run and rank, and one JSON line (rank 0), also written to
``chiprun_out/grid_walls.json`` (``grid_walls_nuts.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(name, model, dev):
    """``fit_model`` of ``model``: wall, collective seconds, memory peak,
    launches; None on a rank the grid leaves idle."""
    import torch

    import chip_smoke as cs
    if model.grid is not None and model.grid.idle:
        return None
    fn = model.lnprob_batch()
    for k in cs.KERNELS:
        cs._kernel(k).launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    coll, undo = cs._collective_clock()
    try:
        _sync(dev)
        t0 = time.perf_counter()
        model.fit_model()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        undo()
    steps = model.cfg.nsteps
    return {"run": name, "grid": None if model.grid is None
            else model.grid.shape, "engine": getattr(fn, "engine", "?"),
            "wall_s": wall, "ms_per_step": wall / steps * 1e3,
            "collective_s": coll[0], "collective_calls": coll[1],
            "collective_share": coll[0] / wall,
            "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                         if dev.type == "cuda" else None),
            "launches": {k: cs._kernel(k).launches for k in cs.KERNELS
                         if cs._kernel(k).launches}}


def _run_nuts(name, model, dev, warmup, nchains, pooled):
    """``fit_model_nuts`` of ``model``: sampling wall, value+gradient
    calls and ms a call on this rank, min ESS and min ESS a second,
    collective seconds, launches; None on a rank the grid leaves idle."""
    import logging

    import chip_smoke as cs
    from lumfuncmcmc_tpu_torch.samplers.diagnostics import (
        effective_sample_size)
    if model.grid is not None and model.grid.idle:
        return None
    for k in cs.KERNELS:
        cs._kernel(k).launches = 0
    rec = cs._Records()
    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    log.addHandler(rec)
    coll, undo = cs._collective_clock()
    try:
        model.fit_model_nuts(num_warmup=warmup, nchains=nchains,
                             pooled=pooled)
    finally:
        undo()
        log.removeHandler(rec)
    secs = rec.value("Total time taken:")
    c = model.nuts_counts
    calls = c.transitions + c.leapfrogs
    ess = float(effective_sample_size(model.chain).min())
    return {"run": name, "grid": None if model.grid is None
            else model.grid.shape, "sampling_s": secs, "calls": calls,
            "ms_per_call": secs / calls * 1e3,
            "leapfrogs_per_transition": c.leapfrogs / c.transitions,
            "min_ess": ess, "min_ess_per_s": ess / secs,
            "collective_s": coll[0], "collective_calls": coll[1],
            "launches": {k: cs._kernel(k).launches for k in cs.KERNELS
                         if cs._kernel(k).launches}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--mega-steps", type=int, default=500)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--nuts", action="store_true",
                    help="the NUTS runs instead of the stretch ones")
    ap.add_argument("--nuts-warmup", type=int, default=100)
    ap.add_argument("--nuts-steps", type=int, default=100)
    ap.add_argument("--nuts-chains", type=int, default=8)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from lumfuncmcmc_tpu_torch.parallel import distributed as pd
    pd.init_from_env(backend="gloo" if args.device == "cpu" else "nccl")
    dev = pd.rank_device(args.device)
    n, me = pd.world_size(), pd.rank()
    cs.GRID_MEGA_STEPS = args.mega_steps
    smi = "not read"
    if dev.type == "cuda":
        import subprocess
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index)],
            capture_output=True, text=True).stdout.strip()
    rows = []
    runs = [
        ("fit (1,1)", lambda: cs._flagship_model(
            dev, nsteps=args.steps, mesh_walkers=1, mesh_sources=1)),
        (f"fit ({n},1)", lambda: cs._flagship_model(
            dev, nsteps=args.steps, mesh_walkers=n, mesh_sources=1)),
        ("mega (1,1)", lambda: cs._grid_mega_model(
            dev, mesh_walkers=1, mesh_sources=1)[0]),
        (f"mega (1,{n})", lambda: cs._grid_mega_model(
            dev, mesh_walkers=1, mesh_sources=n)[0]),
    ]
    if args.nuts:
        def nuts(shape):
            return lambda: cs._flagship_model(
                dev, nsteps=args.nuts_steps, mesh_walkers=shape[0],
                mesh_sources=shape[1])
        nkw = (args.nuts_warmup, args.nuts_chains)
        runs = [("nuts (1,1)", nuts((1, 1)), nkw + (None,)),
                (f"nuts ({n},1) replicas", nuts((n, 1)), nkw + (None,)),
                (f"nuts ({n},1) pooled", nuts((n, 1)), nkw + (True,))]
    else:
        runs = [(name, make, None) for name, make in runs]
    if dev.type == "cpu":       # a rehearsal: small grids and mega cut
        import functools

        from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
        cs.LFConfig = functools.partial(cs.LFConfig, size_ln=21,
                                        use_pallas=True)
        cs.MEGA_TARGET, cl.STREAM_MIN_SOURCES = 120_000, 5_000
    for name, make, nuts_kw in runs:
        model = make()
        res = (_run(name, model, dev) if nuts_kw is None
               else _run_nuts(name, model, dev, *nuts_kw))
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        if res is not None and nuts_kw is not None:
            res["rank"] = me
            print(f"rank {me}: {name}: {res['ms_per_call']:.3f} ms a "
                  f"value+gradient call ({res['calls']} calls, "
                  f"{res['sampling_s']:.3f} s, "
                  f"{res['leapfrogs_per_transition']:.2f} leapfrogs a "
                  f"transition), min ESS {res['min_ess']:.1f}, "
                  f"{res['min_ess_per_s']:.3f} a second, collectives "
                  f"{res['collective_s']:.3f} s in {res['collective_calls']} "
                  f"calls, launches {res['launches']}", flush=True)
        elif res is not None:
            res["rank"] = me
            print(f"rank {me}: {name}: {res['ms_per_step']:.3f} ms a step "
                  f"({res['wall_s']:.3f} s), collectives "
                  f"{res['collective_s']:.3f} s in {res['collective_calls']} "
                  f"calls ({100 * res['collective_share']:.1f}%), memory "
                  f"peak {res['peak_mib']} MiB, launches {res['launches']}, "
                  f"engine {res['engine']}", flush=True)
        got = [None] * n
        dist.all_gather_object(got, res)
        rows.extend(r for r in got if r is not None)
    if me == 0:
        out = {"world": n, "device": smi, "torch": torch.__version__,
               "steps": args.steps, "mega_steps": args.mega_steps,
               "runs": rows}
        if args.nuts:
            out.update(nuts_warmup=args.nuts_warmup,
                       nuts_steps=args.nuts_steps,
                       nuts_chains=args.nuts_chains)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "grid_walls%s.json"
                               % ("_nuts" if args.nuts else "")),
                  "w") as fh:
            json.dump(out, fh, indent=1)
        print(smi)
        print(json.dumps(out))
    pd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
