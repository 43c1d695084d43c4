"""On-card smoke test of the PyTorch/CUDA port (``lumfuncmcmc_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (run as 1, 2, 10, 3, 4, 11, 13, then the fit paths and 9); any
failure ends the run with a nonzero exit:

1. require CUDA; print the torch/CUDA versions, the card, and
   ``nvidia-smi``'s name and power limit;
2. build the kernels of ``lumfuncmcmc_tpu_torch/csrc/`` from source (one
   ``nvcc`` over ``lnlike.cu``, ``lnlike_z.cu``, ``lnlike_h.cu``,
   ``lnlike_stream.cu`` and ``roofline.cu``; each kernel's registers);
3. each value kernel against its plain PyTorch version on the card
   (float32, rtol 1e-4) and both against the float64 eager engine (rtol
   5e-4), on the fits' own catalog (``fit --synthetic 2000``'s) at
   trapz-101 and gauss-32 (``free_lnlike``) and trapz-201
   (``fixed_lnlike``, ``z_lnlike``, ``hier_lnlike``), for the batches the
   fits give them (50 and 100 walkers; 8 chains for the NUTS start guard,
   samples x 8 rows for its Ln Prob recompute) and 13, with out-of-box
   thetas, a negative Flim (free), a row on the ``sch_al`` bound (z) and a
   ``sig_L = 0`` row (hier, in both ``fix_sch_al`` layouts); kernel and
   plain times; the one-launch value kernels (``z_lnlike``,
   ``hier_lnlike``: ``ONE_LAUNCH``) also held to two launches on one input
   bit for bit, to their tickets back at 0, and at W = 50 to one kernel
   node a call (``torch.profiler``);
4. each value+gradient kernel (``free_lnlike_vg``, ``fixed_lnlike_vg``,
   ``z_lnlike_vg``, ``hier_lnlike_vg``) the same way at W = 1, 8 and 256
   (values rtol 1e-4, gradients by the JAX package's ``_grad_close`` rule
   at 2e-3), and the theta-level value+gradient against float64 eager
   autograd (5e-4, 2e-3), the z model under both ``z_param``s, the
   hierarchical one with and without ``-fsa``; every one of them is one
   launch a call (``ONE_LAUNCH``), also held to two launches on one input
   bit for bit and to its tickets back at 0, and at the NUTS shapes timed
   at W = 1 too, with its split: the kernel's own device time
   (``torch.profiler``) beside an empty kernel's in the same harness;
5. the port's ``fit`` CLI end to end (100 walkers x 2000 steps on a
   2000-source synthetic catalog), free and fixed completeness: the JAX
   CLI's artifact set, finite Ln Prob, a sane acceptance fraction, and
   launch counters proving the sampler went through the kernels;
6. ``fit --sampler nuts`` on the same catalog (8 chains, 200 warmup, 150
   samples free and 200 fixed): artifacts, divergences < 5%, mean
   accept-stat in (0.6, 0.97), max R-hat < 1.1, the logL* median within
   3 posterior sd of the stretch fit's, and value+gradient launches equal
   to the sampler's transitions + leapfrog steps;
7. ``fitz`` the same way as 5 (into ``LFMCMCzOut/``, the LF matrix
   columns of ``bestfitLF``, the middle pivots constraining: posterior sd
   of L2 and phi2 < 0.8) and ``fitz --sampler nuts`` as 6 at 300
   samples, its L2 median held to the stretch ``fitz``'s;
8. ``fith`` the same way as 5 (into ``LFMCMCHOut/``, 15-dim theta; the
   ``mu_L`` median within 0.4 and every ``Lstar_f`` median within 0.5 of
   the catalog's true logL*, the JAX package's own bars) and ``fith
   --sampler nuts`` as 6 at 300 samples, its ``mu_L`` median held to the
   stretch ``fith``'s;
9. ``vmax`` on the same catalog, and with ``--zbins 3``: the ``.dat`` and
   ``.png`` artifacts under the image directory, finite positive
   ``BinLF``, and a finite Schechter fit whose ``Lstar`` and ``al`` lie
   inside their bounds and not on them (a z bin's ``al``, known to +-0.3,
   may sit on its upper bound, where the LM ends without its flag);
10. the same-mix roofline: ``roofline_chain`` against its plain version
   (rtol 1e-5), then its main path, ``transcendental_peak``, with the
   counter set to 0 before and read after: the card's sustained rate on
   the likelihood's own transcendental mix, which gives every kernel a
   second bound (``same_mix_ms``: its transcendentals over that rate);
11. the streaming kernels (``free_stream_lnlike``,
   ``free_stream_lnlike_vg``) on the mega catalog (``fit --synthetic
   1200000 --seed 7 --quadrature gauss``'s: 1,019,385 sources), at the
   batches its fits give them (value W = 50 and an odd 51; vg W = 1, 8,
   256): against their plain versions (rtol 1e-4 values, 2e-3 gradients),
   at theta level against the float64 eager engine (5e-4, 2e-3), the lnp
   difference of 32 close theta pairs near the truth against float64
   through each kernel's value (<= 0.05 absolute), two launches on one
   input bit for bit, and the sum of 2 shards against one (1e-6); the
   resident kernels' times at the same shape beside theirs;
12. ``fit mega``: ``fit`` and ``fit --sampler nuts`` on that catalog with
   ``use_x64`` (float64 lnprob, float32 kernels): the artifacts, the log's
   1,019,385 sources and streaming engine, exact launch counts (stretch
   2 x steps + 1 ``free_stream_lnlike`` and no ``free_lnlike``; NUTS
   transitions + leapfrogs ``free_stream_lnlike_vg``), the NUTS gates,
   the stretch fit's ``select_samples`` logL* median within 3 NUTS
   posterior sd of the NUTS median and within 0.05 dex of the truth;
13. the accept step's precision of ``fit -fc``, ``fitz`` and ``fith`` on
   the mega catalog (ROADMAP C.1): as a float64 run takes them (float32
   kernels), the lnp differences of 32 close theta pairs near the truth
   through ``fixed_lnlike``, ``z_lnlike``, ``hier_lnlike`` and the value
   column of each ``_vg`` twin, against the float64 eager engine (<= 0.05
   absolute, each error printed).

Phases 5-8 and 12 run side by side, each path's stretch and NUTS fit in
a process of its own (``--path``): the sampler loops are host-bound, so
the five take about the time of the longest. Each fit runs with every
launch counter set to 0 just before it and read just after. Prints the
kernel summary as one JSON line, then the device line last.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.cli.main import main as cli_main
from lumfuncmcmc_tpu_torch.models.context import build_context
from lumfuncmcmc_tpu_torch.models.hierarchical import (
    ThetaLayoutH, make_lnprob_h)
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, make_lnprob, sample_init)
from lumfuncmcmc_tpu_torch.models.likelihood_z import (
    ThetaLayoutZ, make_lnprob_z)
from lumfuncmcmc_tpu_torch.models.model import select_samples
from lumfuncmcmc_tpu_torch.ops import _build
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.ops import roofline as rl
from lumfuncmcmc_tpu_torch.utils.io import read_fixed_width_two_line
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

RTOL_KERNEL = 1e-4   # f32 sums of <= 2e5 terms in another order
RTOL_F64 = 5e-4      # the JAX package's Pallas-vs-f64 bar
RTOL_GRAD = 2e-3     # the JAX package's gradient bar (_grad_close)
# kernels of one launch a call: held bit for bit over two launches, to
# their tickets back at 0 and to one kernel node a call, their time split
# in phases 3 and 4
ONE_LAUNCH = ("z_lnlike", "hier_lnlike", "free_lnlike_vg",
              "fixed_lnlike_vg", "z_lnlike_vg", "hier_lnlike_vg")
NSTEPS, NWALKERS, NSYNTH = 2000, 100, 2000
NUTS_CHAINS, NUTS_WARMUP = 8, 200
# NUTS samples by kernel family (warmup is the CLI's 200 and holds most of
# the leapfrogs, so the samples are what a depth cut can take)
NUTS_STEPS = {"free": 150, "fixed": 200, "z": 300, "hier": 300,
              "mega": 150}
CSRC = "lumfuncmcmc_tpu_torch/csrc/"
TPU_FILE = "lumfuncmcmc_tpu/ops/pallas_lnlike.py"
KERNELS = ("free_lnlike", "fixed_lnlike", "free_lnlike_vg",
           "fixed_lnlike_vg", "z_lnlike", "z_lnlike_vg", "hier_lnlike",
           "hier_lnlike_vg", "free_stream_lnlike", "free_stream_lnlike_vg",
           "roofline_chain")
PATH_SECONDS = 900      # what the fit paths' processes may take together
DEVICE_LINE = "Device: cuda:0"      # what a run on the card logs first
# the mega catalog: the JAX benchmark's stream tier (make_catalog with
# n_target 1.2e6, seed 7, gauss-32 quadrature)
MEGA_TARGET, MEGA_SEED, MEGA_SOURCES = 1_200_000, 7, 1_019_385
MEGA_STEPS = 2000       # stretch steps of the mega fit
DLNP_TOL = 0.05         # lnp difference of close thetas vs float64
SOURCES = {"z": "lnlike_z.cu", "hier": "lnlike_h.cu",
           "fixed_lnlike_vg": "lnlike_h.cu",
           "free_stream": "lnlike_stream.cu", "roofline": "roofline.cu"}
# The card's peaks for the bound (H100 SXM at 700 W): float32 outside the
# tensor cores, and HBM.
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
# float32 operations per cell evaluation, counted from csrc/lnlike.cu (an FMA
# is 2, each exp/log/rsqrt/div/max/compare 1; fcmin > 0): the value
# kernels' free grid cell 23 and unmasked source 23 (a masked one 1),
# fixed grid cell 8; the value+gradient kernels' free grid cell 46 and
# unmasked source 45, fixed grid cell 12.
# From csrc/lnlike_z.cu, a third count per (walker, field, z node) for the
# hoisted node quantities, the least the function needs whatever forms
# them: z_lnlike grid cell 7, unmasked source 16, node 12; z_lnlike_vg grid
# cell 11, unmasked source 31, node 25 (the end-of-column contraction
# included).
# From csrc/lnlike_h.cu: the fixed-completeness cells, hier_lnlike 8 and
# hier_lnlike_vg 12 (the per-field lookup is three loads per block).
# From csrc/lnlike_stream.cu: the grid cells as in lnlike.cu, an unmasked
# source's ln fc alone (the affine terms are collapsed on the host) 15 and
# with its derivatives 33.
# From csrc/roofline.cu: 26 per element and iteration.
OPS = {"free_lnlike": (23, 23, 0), "fixed_lnlike": (8, 0, 0),
       "free_lnlike_vg": (46, 45, 0), "fixed_lnlike_vg": (12, 0, 0),
       "z_lnlike": (7, 16, 12), "z_lnlike_vg": (11, 31, 25),
       "hier_lnlike": (8, 0, 0), "hier_lnlike_vg": (12, 0, 0),
       "free_stream_lnlike": (23, 15, 0),
       "free_stream_lnlike_vg": (46, 33, 0), "roofline_chain": (26, 0, 0)}
# Transcendentals (exp/log/rsqrt, the roofline's convention) per grid
# cell, unmasked source and z node: a free cell rsqrt, log, the decay exp
# and the integrand exp; a free source the first three; the fixed,
# hierarchical and z cells one exp (a z source one, a z node one).
TRANS = {"free": (4, 3, 0), "fixed": (1, 0, 0), "z": (1, 1, 1),
         "hier": (1, 0, 0), "roofline": (4, 0, 0)}


_SMI = ["not read"]     # nvidia-smi's name and power limit line


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
    _SMI[:] = [smi.stdout.strip().splitlines()[0]]
    print(_SMI[0])


def phase_build():
    path = _build.build()
    print(f"kernel build: {_build.build_seconds:.2f} s -> "
          f"{os.path.relpath(path)}")
    kernel = "?"
    for line in _build.build_log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif "registers" in line or ("spill" in line and not re.search(
                r"0 bytes spill stores, 0 bytes spill loads", line)):
            print(f"  ptxas: {kernel}: {line.split(':', 1)[-1].strip()}")
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


def _kernel_us(fn, calls=50):
    """Each CUDA kernel's own device time per ``fn()`` call (us), by name,
    from ``torch.profiler`` over ``calls`` eager calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = re.sub(r"^void ", "", evt.key.split("(")[0]).strip()
        out[name] = out.get(name, 0.0) + us / calls
    return out


def _empty_ms():
    """One empty kernel's time in the :func:`_device_ms` harness: the
    floor under every kernel's."""
    lib = _build.load_library()

    def empty():
        rc = lib.empty_launch(1, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"empty_launch: CUDA error {rc}")
    return _device_ms(empty)


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


def _grad_rel(gp, gref):
    """The JAX package's ``_grad_close`` measure (tests/test_pallas.py):
    |gp - gref| over max(|gref|, 1e-3 of the row's largest component)."""
    denom = torch.maximum(gref.abs(), 1e-3 * gref.abs().amax(
        dim=-1, keepdim=True))
    return float(((gp - gref).abs() / denom).max())


def _kernel(name):
    """The wrapper of kernel ``name`` (its ``.launches`` counter)."""
    return rl.roofline_chain if name == "roofline_chain" else getattr(
        cl, name)


def _source(name):
    for key, src in SOURCES.items():
        if name.startswith(key):
            return CSRC + src
    return CSRC + "lnlike.cu"


def _bound(kname, data, w):
    """Least time the card could take for one call of ``kname`` on these
    inputs: the larger of bytes (each input read once, each output
    written once) over HBM bandwidth and float32 operations (this data's
    cells, unmasked sources and, for the z kernels, each field's z nodes)
    over the float32 peak. ``w`` is the walker batch (the iteration count for
    ``roofline_chain``, whose ``data`` is its input).
    Returns ``(bound_ms, bound_by, bytes, ops, transcendentals)``."""
    fam = kname.split("_")[0]
    per_cell, per_src, per_node = OPS[kname]
    if fam == "roofline":
        nbytes, ops = 8 * data.numel(), per_cell * w * data.numel()
        trans = TRANS[fam][0] * w * data.numel()
        t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations", nbytes, ops,
                trans)
    stream = "stream" in kname
    ncell = data.g_a.numel()
    gridonly = fam in ("fixed", "hier")
    if stream:
        nsrc, nvalid = data.s_logf.shape[1], int((data.s_mask[0] > 0).sum())
    else:
        nsrc = 0 if gridonly else data.s_a.numel()
        nvalid = 0 if gridonly else int((data.s_mask > 0).sum())
    if fam == "z":
        nfeat, nf, sz = 7, data.shape[0], data.shape[2]
        nnode = nf * sz
        ndata = 3 * ncell + 2 * nf * sz + 5 * nsrc
    else:
        nfeat = {"fixed": 4, "hier": 1 + 3 * data.nfields}.get(
            fam, 6 + 2 * data.nfields)
        nnode = 0
        ndata = (3 if gridonly else 5) * ncell + (3 if stream else 6) * nsrc
    out_cols = (1 + nfeat) if kname.endswith("_vg") else 1
    out_bytes = 8 * w * out_cols
    # a two-pass kernel reads its chunk (or run) table; a one-launch
    # kernel's piece tables are its implementation's, not the function's
    table = 0 if kname in ONE_LAUNCH else (
        data.runs if stream else data.chunks).numel()
    nbytes = 4 * (w * nfeat + ndata + table) + out_bytes
    ops = w * (ncell * per_cell + nvalid * per_src + (nsrc - nvalid)
               + nnode * per_node)
    tc, ts, tn = TRANS[fam]
    trans = w * (ncell * tc + nvalid * ts + nnode * tn)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops,
            trans)


def _one_node(kname, grid, w, fn, empty_ms):
    """The split of a one-launch kernel's call: its kernels' own device
    times (``torch.profiler``), which must be one node; fails otherwise."""
    kus = _kernel_us(fn)
    print(f"{kname} {grid} W={w} split: one launch; the kernel's own "
          f"device time { {k: round(v, 2) for k, v in kus.items()} } us "
          f"(torch.profiler), an empty kernel {empty_ms * 1e3:.2f} us")
    if len(kus) != 1:
        fail(f"{kname} {grid} W={w}: {len(kus)} kernel nodes a call, "
             f"expected one: {sorted(kus)}")
    return kus


def _central_thetas(cfg, layout, w, gen, dev):
    """``w`` walkers within ~1% of the box width of the catalog's true
    parameters, where a fit spends its steps. Uniform prior draws reach
    |lnL| ~ 1e12, where float32's spacing alone is ~6e4, so the absolute
    error reported for a kernel is taken here."""
    vals = {"Lstar": cfg.Lstar, "phistar": cfg.phistar,
            "sch_al": cfg.sch_al, "alpha": cfg.alpha,
            "L1": cfg.Lstar, "L2": cfg.Lstar, "L3": cfg.Lstar,
            "phi1": cfg.phistar, "phi2": cfg.phistar, "phi3": cfg.phistar,
            "Lmid": cfg.Lstar, "Lslope": 0.0, "Lcurv": 0.0,
            "pmid": cfg.phistar, "pslope": 0.0, "pcurv": 0.0,
            "mu_L": cfg.Lstar, "sig_L": 0.3, "mu_p": cfg.phistar,
            "sig_p": 0.5}
    for i in range(len(cfg.Flim)):
        vals.update({f"Flim_{i}": cfg.Flim[i], f"Lstar_{i}": cfg.Lstar,
                     f"phistar_{i}": cfg.phistar})
    c = torch.tensor([vals[n] for n in layout.names], dtype=torch.float64,
                     device=dev)
    lo, hi = layout.bounds_arrays(torch.float64, dev)
    th = c + 0.01 * (hi - lo) * torch.randn(
        (w, c.numel()), generator=gen, dtype=torch.float64, device=dev)
    return torch.minimum(torch.maximum(th, lo), hi)


def _in_rows(fn, th, rows):
    """``fn`` over ``th`` in pieces of ``rows`` rows: the float64 eager
    engine holds several (rows, cells) temporaries at once."""
    return torch.cat([fn(th[i:i + rows]) for i in range(0, len(th), rows)])


def _cases(dev, suffix):
    """The checked shapes, on the catalog the fits below build (``fit
    --synthetic NSYNTH``, cli/common.py), so each kernel sees the sources
    and chunks the fits give it. Each case carries its kernel's name, grid,
    config, layout and float32 kernel data, and its family's feature map
    (rounded float64 rows), host-side collapsed terms, float64 eager
    lnprob, prior test and kernel-path lnprobs."""
    base = LFConfig(min_comp_frac=0.5)
    cat = apply_completeness_cut(
        make_catalog(base, n_target=NSYNTH, seed=base.seed), base)
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"], device=dev)
    ctxs = {}       # z_param changes the theta map only, not the context
    for fam, grid, cfg in (
            ("free", "trapz-101", base),
            ("free", "gauss-32", base.replace(quadrature="gauss")),
            ("fixed", "trapz-201", base.replace(fix_comp=True)),
            ("z", "trapz-201", base.replace(fix_comp=True)),
            ("z", "trapz-201 natural",
             base.replace(fix_comp=True, z_param="natural")),
            ("hier", "trapz-201", base.replace(fix_comp=True)),
            ("hier", "trapz-201 fsa",
             base.replace(fix_comp=True, fix_sch_al=True))):
        if cfg.z_param == "natural" and not suffix:
            continue    # z_param changes the theta map: a theta-level case
        key = (cfg.fix_comp, cfg.quadrature)
        if key not in ctxs:
            ctxs[key] = [build_context(cfg, dtype=dt, **kw)[1]
                         for dt in (torch.float32, torch.float64)]
        ctx32, ctx64 = ctxs[key]
        model = fam if fam in ("z", "hier") else "single"
        layout = {"z": ThetaLayoutZ, "hier": ThetaLayoutH}.get(
            fam, ThetaLayout).from_config(cfg)
        eager = {"z": make_lnprob_z, "hier": make_lnprob_h}.get(
            fam, make_lnprob)
        data, (features, collapsed, inside, _, _) = cl._family(
            ctx32, layout, model, torch.float32)
        case = SimpleNamespace(
            data=data, inside=inside, eager64=eager(ctx64, layout),
            lnprob32=cl._make_lnprob(ctx32, layout, model, grad=False),
            steps=NUTS_STEPS[fam])
        # the rounded float64 features, and the float64 terms the host
        # adds to the kernel's value (fixed: the collapsed ln-term; hier:
        # lnrest)
        case.features = (lambda th, features=features, data=data,
                         layout=layout: features(th, data, layout,
                                                 torch.float32))
        case.collapsed = collapsed or (lambda f, th: 0.0)
        case.post32 = cl.make_cuda_lnprob_and_grad(ctx32, layout,
                                                   model=model)
        case.kname, case.fam, case.grid = f"{fam}_lnlike{suffix}", fam, grid
        case.cfg, case.layout = cfg, layout
        yield case


def _spoil(case, th):
    """Plant the rows a fit can meet: an out-of-box theta last, and
    before it a negative Flim (free), a second out-of-box theta (fixed),
    a theta on the ``sch_al`` bound, which the z prior keeps (z), or a
    ``sig_L`` of 0, where the hyperprior's ``1/sig`` diverges (hier)."""
    layout = case.layout
    th[-1, 0] = layout.hi[0] + 1.0
    if case.fam == "z":
        th[-2, 6] = layout.hi[6]
    elif case.fam == "hier":
        th[-2, 1] = 0.0
    elif layout.fix_comp:
        th[-2, 1] = layout.hi[1] + 0.5
    else:
        th[-2, 2 if layout.fix_sch_al else 3] = -1.0
    return th


def phase_kernels(dev):
    """Kernel vs plain version vs float64 eager engine on the card."""
    summary = {}
    empty_ms = _empty_ms()
    for case in _cases(dev, ""):
        kname, grid, layout, data = (case.kname, case.grid, case.layout,
                                     case.data)
        one = kname in ONE_LAUNCH
        lo, hi = layout.bounds_arrays(torch.float64, dev)
        kernel = getattr(cl, kname)
        plain = getattr(cl, kname + "_reference")

        rec = summary.setdefault(kname, {"max_abs_err": 0.0,
                                         "max_rel_err": 0.0})

        def features(th):
            return case.features(th.float())

        def whole(part, feats, th):
            """The kernel's value plus the host's collapsed terms."""
            return part + case.collapsed(feats, th.float())

        # the stretch fits' batches (half and all of the walkers), the
        # NUTS start guard's (the chains) and its Ln Prob recompute's
        # (samples x chains), and an odd one
        for w in (50, NWALKERS, 13, NUTS_CHAINS, case.steps * NUTS_CHAINS):
            gen = torch.Generator(device=dev).manual_seed(1000 + w)
            th = _spoil(case, sample_init(gen, layout, w,
                                          dtype=torch.float64, device=dev))
            feats = features(th)
            f32 = feats.float()
            got = kernel(f32, data)
            again = kernel(f32, data) if one else got
            ref = plain(f32, data)
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
                fail(f"{kname} {grid} W={w}: non-finite raw lnlike")
            if not torch.equal(got, again):
                fail(f"{kname} {grid} W={w}: two launches on one input "
                     "differ")
            if one and data.vg_tickets.any():
                fail(f"{kname} {grid} W={w}: tickets not back at 0")
            err_k = _rel(got, ref)
            ok = case.inside(th, lo, hi)
            if int((~ok).sum()) != (1 if case.fam == "z" else 2):
                fail(f"{kname} {grid} W={w}: {int((~ok).sum())} rows "
                     "outside the prior")
            want = _in_rows(case.eager64, th, 300)
            fin = torch.isfinite(want)
            if not torch.equal(fin, ok):
                fail(f"{kname} {grid} W={w}: eager -inf pattern is not "
                     "the prior mask")
            err_kf = _rel(whole(got, feats, th)[fin], want[fin])
            err_pf = _rel(whole(ref, feats, th)[fin], want[fin])
            print(f"{kname} {grid} W={w}: kernel vs plain max rel "
                  f"{err_k:.3e}; kernel vs f64 eager {err_kf:.3e}; plain "
                  f"vs f64 eager {err_pf:.3e}; -inf rows "
                  f"{int((~fin).sum())}" + "; two launches bit-identical, "
                  "tickets at 0" * one)
            if err_k > RTOL_KERNEL:
                fail(f"{kname} {grid} W={w}: kernel vs plain {err_k:.3e} "
                     f"> {RTOL_KERNEL}")
            if max(err_kf, err_pf) > RTOL_F64:
                fail(f"{kname} {grid} W={w}: vs f64 eager "
                     f"{max(err_kf, err_pf):.3e} > {RTOL_F64}")
            # the whole lnprob path gives the same -inf pattern
            if not torch.equal(torch.isfinite(case.lnprob32(th.float())),
                               fin):
                fail(f"{kname} {grid} W={w}: lnprob -inf pattern differs")
            rec["max_rel_err"] = max(rec["max_rel_err"], err_k)
            if w == 50:
                thc = _central_thetas(case.cfg, layout, w, gen, dev)
                fc = features(thc)
                got_c, ref_c = kernel(fc.float(), data), plain(fc.float(),
                                                               data)
                want_c = case.eager64(thc)
                abs_c = float((got_c - ref_c).abs().max())
                err_c = _rel(got_c, ref_c)
                err_cf = _rel(whole(got_c, fc, thc), want_c)
                print(f"{kname} {grid} W=50 near the true parameters: "
                      f"kernel vs plain max abs {abs_c:.3e} (|lnL| <= "
                      f"{float(ref_c.abs().max()):.3e}), max rel "
                      f"{err_c:.3e}; kernel vs f64 eager {err_cf:.3e}")
                if err_c > RTOL_KERNEL or err_cf > RTOL_F64:
                    fail(f"{kname} {grid} near the true parameters: "
                         f"{err_c:.3e} vs plain, {err_cf:.3e} vs f64 eager")
                rec["max_abs_err"] = max(rec["max_abs_err"], abs_c)
                rec["max_rel_err"] = max(rec["max_rel_err"], err_c)
                ms = _device_ms(lambda: kernel(f32, data))
                pms = _device_ms(lambda: plain(f32, data))
                cms = _call_ms(lambda: kernel(f32, data))
                print(f"{kname} {grid} W=50 device time: kernel "
                      f"{ms * 1e3:.2f} us, plain {pms * 1e3:.2f} us; "
                      f"eager wrapper call {cms * 1e3:.2f} us")
                if grid in ("trapz-101", "trapz-201"):   # flagship shapes
                    bms, by, nb, nops, ntr = _bound(kname, data, w)
                    print(f"{kname} {grid} W=50 bound: {bms * 1e3:.4f} us "
                          f"({by}: {nb} bytes, {nops} f32 operations)")
                    rec.update(ms=ms, plain_ms=pms, call_ms=cms,
                               bound_ms=bms, bound_by=by, trans=ntr,
                               shape=f"W=50, {grid}, "
                                     f"{data.g_a.shape[0]} cells")
                    if one:
                        kus = _one_node(kname, grid, w,
                                        lambda: kernel(f32, data), empty_ms)
                        rec["split"] = {"call_us": ms * 1e3,
                                        "kernels_us": kus,
                                        "empty_kernel_us": empty_ms * 1e3}
    return summary


def _eager_value_and_grad(case, th):
    """Float64 eager autograd over ``th``, 64 rows at a time."""
    vals, grads = [], []
    for i in range(0, len(th), 64):
        t = th[i:i + 64].clone().requires_grad_(True)
        v = case.eager64(t)
        grads.append(torch.autograd.grad(v.sum(), t)[0])
        vals.append(v.detach())
    return torch.cat(vals), torch.cat(grads)


def phase_vg_kernels(dev):
    """Value+gradient kernels vs their plain versions, and the
    theta-level value+gradient vs float64 eager autograd, on the card."""
    summary = {}
    empty_ms = _empty_ms()
    print(f"an empty kernel: {empty_ms * 1e3:.2f} us (graph replay)")
    for case in _cases(dev, "_vg"):
        kname, grid, layout, data = (case.kname, case.grid, case.layout,
                                     case.data)
        one = kname in ONE_LAUNCH
        nuts_shape = grid in ("trapz-101", "trapz-201")
        kernel = getattr(cl, kname)
        plain = getattr(cl, kname + "_reference")
        lo, hi = layout.bounds_arrays(torch.float64, dev)
        rec = summary.setdefault(kname, {"max_abs_err": 0.0,
                                         "max_rel_err": 0.0,
                                         "max_grad_err": 0.0})
        for w in (1, 8, 256):
            gen = torch.Generator(device=dev).manual_seed(2000 + w)
            # prior draws shrunk toward the box centre, where chains
            # move (the JAX package's vg tests take the same thetas);
            # from W = 8 on, the last two rows are _spoil's
            th = 0.7 * (lo + hi) / 2 + 0.3 * sample_init(
                gen, layout, w, dtype=torch.float64, device=dev)
            th = th.float().double()    # both paths get the same thetas
            if w >= 8:
                _spoil(case, th)
            feats = case.features(th.float()).float()
            got = kernel(feats, data)
            again = kernel(feats, data) if one else got
            ref = plain(feats, data)
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
                fail(f"{kname} {grid} W={w}: non-finite raw rows")
            if not torch.equal(got, again):
                fail(f"{kname} {grid} W={w}: two launches on one input "
                     "differ")
            if one and data.vg_tickets.any():
                fail(f"{kname} {grid} W={w}: tickets not back at 0")
            ok = case.inside(th, lo, hi)
            err_v = _rel(got[ok, 0], ref[ok, 0])
            err_g = _grad_rel(got[ok, 1:], ref[ok, 1:])
            # theta level: kernel path vs float64 eager autograd
            t32 = th.float().requires_grad_(True)
            v32 = case.post32(t32)
            (g32,) = torch.autograd.grad(v32.sum(), t32)
            v64, g64 = _eager_value_and_grad(case, th)
            if (torch.isfinite(v32) != ok).any() or (
                    g32[~ok] != 0).any() or not torch.isfinite(g32).all():
                fail(f"{kname} {grid} W={w}: out-of-box rows are not -inf "
                     "with a zero gradient")
            err_tv = _rel(v32.detach().double()[ok], v64[ok])
            err_tg = _grad_rel(g32.double()[ok], g64[ok])
            print(f"{kname} {grid} W={w}: kernel vs plain value max rel "
                  f"{err_v:.3e}, gradient {err_g:.3e}; theta-level vs f64 "
                  f"eager autograd value {err_tv:.3e}, gradient "
                  f"{err_tg:.3e}" + "; two launches bit-identical, tickets "
                  "at 0" * one)
            if err_v > RTOL_KERNEL or err_g > RTOL_GRAD:
                fail(f"{kname} {grid} W={w}: kernel vs plain {err_v:.3e} "
                     f"(value), {err_g:.3e} (gradient)")
            if err_tv > RTOL_F64 or err_tg > RTOL_GRAD:
                fail(f"{kname} {grid} W={w}: vs f64 eager autograd "
                     f"{err_tv:.3e} (value), {err_tg:.3e} (gradient)")
            rec["max_rel_err"] = max(rec["max_rel_err"], err_v)
            rec["max_grad_err"] = max(rec["max_grad_err"], err_g)
            if (w == 1 and not (one and nuts_shape)) or grid.endswith(
                    ("natural", "fsa")):
                continue    # the same kernel on the same data
            if w == 8:
                # the absolute error where a fit spends its steps (prior
                # draws reach |lnL| ~ 1e7, where float32's spacing is ~1)
                fc = case.features(_central_thetas(
                    case.cfg, layout, w, gen, dev).float()).float()
                got_c, ref_c = kernel(fc, data), plain(fc, data)
                abs_c = float((got_c[:, 0] - ref_c[:, 0]).abs().max())
                err_gc = _grad_rel(got_c[:, 1:], ref_c[:, 1:])
                print(f"{kname} {grid} W=8 near the true parameters: "
                      f"kernel vs plain value max abs {abs_c:.3e} (|lnL| "
                      f"<= {float(ref_c[:, 0].abs().max()):.3e}), gradient "
                      f"{err_gc:.3e}")
                if err_gc > RTOL_GRAD or abs_c > RTOL_KERNEL * float(
                        ref_c[:, 0].abs().max()):
                    fail(f"{kname} {grid} near the true parameters: "
                         f"{abs_c:.3e} (value), {err_gc:.3e} (gradient)")
                rec["max_abs_err"] = max(rec["max_abs_err"], abs_c)
            f_w = feats
            ms = _device_ms(lambda: kernel(f_w, data))
            pms = _device_ms(lambda: plain(f_w, data))
            bms, by, nb, nops, ntr = _bound(kname, data, w)
            print(f"{kname} {grid} W={w} device time: kernel "
                  f"{ms * 1e3:.2f} us, plain {pms * 1e3:.2f} us, bound "
                  f"{bms * 1e3:.4f} us ({by}: {nb} bytes, {nops} f32 "
                  "operations)")
            if nuts_shape:
                key = "" if w == 8 else f"_w{w}"
                rec.update({f"ms{key}": ms, f"plain_ms{key}": pms,
                            f"bound_ms{key}": bms, f"bound_by{key}": by,
                            f"trans{key}": ntr})
                if one:
                    kus = _one_node(kname, grid, w,
                                    lambda: kernel(f_w, data), empty_ms)
                    rec[f"split{key}"] = {"call_us": ms * 1e3,
                                          "kernels_us": kus,
                                          "empty_kernel_us": empty_ms * 1e3}
                if w == 8:
                    rec["call_ms"] = _call_ms(lambda: kernel(f_w, data))
                    rec["shape"] = (f"W=8, {grid}, "
                                    f"{data.g_a.shape[0]} cells")
    return summary


def phase_roofline(dev):
    """``roofline_chain`` against its plain version, then its main path,
    ``transcendental_peak``, with the launch counter set to 0 just before
    and read just after. Returns the kernel's summary row and the
    measured rate."""
    gen = torch.Generator(device=dev).manual_seed(15)
    x = 0.05 + 0.9 * torch.rand((256, 1024), generator=gen, device=dev)
    got = rl.roofline_chain(x, 8)
    ref = rl.roofline_chain_reference(x, 8)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = _rel(got, ref)
    print(f"roofline_chain (256, 1024) x 8 iterations: kernel vs plain max "
          f"abs {err:.3e}, max rel {rel:.3e}")
    if not (torch.isfinite(got).all() and rel <= 1e-5):
        fail(f"roofline_chain vs plain {rel:.3e} > 1e-5")
    rl.roofline_chain.launches = 0
    peak = rl.transcendental_peak(dev)
    launches = rl.roofline_chain.launches
    if launches != 2 * (1 + peak["reps"]):
        fail(f"transcendental_peak launched roofline_chain {launches} times")
    it = peak["iters_lo"]
    ms = peak["wall_lo_s"] * 1e3
    xp = 0.05 + 0.9 * torch.rand((peak["rows"], peak["cols"]),
                                 generator=gen, device=dev)
    pms = _call_ms(lambda: rl.roofline_chain_reference(xp, it), inner=1,
                   reps=3)
    bms, by, nb, nops, ntr = _bound("roofline_chain", xp, it)
    print(f"same-mix peak (transcendental_peak, {peak['rows']} x "
          f"{peak['cols']}, {peak['iters_lo']} and {peak['iters_hi']} "
          f"iterations, best of {peak['reps']}): "
          f"{peak['elements_per_sec']:.5e} elements/s, "
          f"{peak['transcendentals_per_sec']:.5e} transcendentals/s, "
          f"{peak['per_iter_s'] * 1e6:.4f} us per iteration, overhead "
          f"{peak['overhead_s'] * 1e6:.2f} us; on {_SMI[0]}")
    print(f"roofline_chain {it} iterations: kernel {ms * 1e3:.2f} us, plain "
          f"{pms * 1e3:.2f} us, bound {bms * 1e3:.3f} us ({by}: {nb} bytes, "
          f"{nops} f32 operations), {launches} launches")
    row = {"max_abs_err": err, "max_rel_err": rel, "ms": ms,
           "plain_ms": pms, "bound_ms": bms, "bound_by": by, "trans": ntr,
           "call_ms": ms, "launches": launches,
           "shape": f"(256, 1024) x {it} iterations",
           "elements_per_sec": peak["elements_per_sec"],
           "transcendentals_per_sec": peak["transcendentals_per_sec"]}
    return row, peak["transcendentals_per_sec"]


def _mega_case(dev):
    """The mega catalog (``fit --synthetic 1200000 --seed 7 --quadrature
    gauss``'s) as a float64 context on the card, its streaming data, the
    truth as a theta, and the float64 eager lnprob."""
    cfg = LFConfig(min_comp_frac=0.5, quadrature="gauss")
    cat = apply_completeness_cut(
        make_catalog(cfg, n_target=MEGA_TARGET, seed=MEGA_SEED), cfg)
    if len(cat["z"]) != MEGA_SOURCES:
        fail(f"the mega catalog has {len(cat['z'])} sources, expected "
             f"{MEGA_SOURCES}")
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           flux_e=cat["flux_e"], field_id=cat["field_id"],
                           device=dev, dtype=torch.float64)
    layout = ThetaLayout.from_config(cfg)
    tt = cat["theta_true"]
    truth = torch.tensor([tt["Lstar"], tt["phistar"], tt["sch_al"],
                          *cfg.Flim, cfg.alpha], dtype=torch.float64,
                         device=dev)
    lo, hi = layout.bounds_arrays(torch.float64, dev)
    return SimpleNamespace(
        cfg=cfg, cat=cat, ctx=ctx, layout=layout, truth=truth,
        width=hi - lo,
        data=cl.prepare_cuda_stream_data(ctx, cfg.fcmin,
                                         dtype=torch.float32),
        eager64=make_lnprob(ctx, layout))


def _close_pairs(center, width, gen, npairs=32):
    """``npairs`` thetas 0.001 box widths around ``center``, then each
    moved by 6e-5 box widths: the accept step's close pairs."""
    base = center + 0.001 * width * torch.randn(
        (npairs, center.numel()), generator=gen, dtype=torch.float64,
        device=center.device)
    return torch.cat([base, base + 6e-5 * width * torch.randn(
        base.shape, generator=gen, dtype=torch.float64,
        device=center.device)])


def _dlnp_err(v, want):
    """Largest error of the lnp differences of the pairs of
    :func:`_close_pairs` (first half vs second half) against ``want``'s."""
    n = len(want) // 2
    return float(((v[n:] - v[:n]) - (want[n:] - want[:n])).abs().max())


def phase_precision(dev, m):
    """The accept step's precision past the float32 crossing (ROADMAP
    C.1) for the resident kernels of ``fit -fc``, ``fitz`` and ``fith``:
    on the mega catalog, as a float64 run takes them (float64 context and
    thetas, float32 kernels), the lnp differences of 32 close theta pairs
    near the truth through each family's value kernel and its
    value+gradient kernel's value column, against the float64 eager
    engine; fails above ``DLNP_TOL``. Returns {kernel: error}."""
    cfg = m.cfg.replace(fix_comp=True)
    cat, tt = m.cat, m.cat["theta_true"]
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           flux_e=cat["flux_e"], field_id=cat["field_id"],
                           device=dev, dtype=torch.float64)
    vals = {"Lstar": tt["Lstar"], "phistar": tt["phistar"],
            "sch_al": tt["sch_al"], "L1": tt["Lstar"], "L2": tt["Lstar"],
            "L3": tt["Lstar"], "phi1": tt["phistar"], "phi2": tt["phistar"],
            "phi3": tt["phistar"], "mu_L": tt["Lstar"], "sig_L": 0.3,
            "mu_p": tt["phistar"], "sig_p": 0.5}
    gen = torch.Generator(device=dev).manual_seed(606)
    errs = {}
    for fam, layout, eager, model in (
            ("fixed", ThetaLayout.from_config(cfg), make_lnprob, "single"),
            ("z", ThetaLayoutZ.from_config(cfg), make_lnprob_z, "z"),
            ("hier", ThetaLayoutH.from_config(cfg), make_lnprob_h, "hier")):
        names = [n.split("_")[0] if n.split("_")[0] in ("Lstar", "phistar")
                 else n for n in layout.names]
        center = torch.tensor([vals[n] for n in names], dtype=torch.float64,
                              device=dev)
        lo, hi = layout.bounds_arrays(torch.float64, dev)
        th = _close_pairs(center, hi - lo, gen)
        want = _in_rows(eager(ctx, layout), th, 16)
        lnprob = cl._make_lnprob(ctx, layout, model, grad=False)
        post = cl.make_cuda_lnprob_and_grad(ctx, layout, model=model)
        if not (lnprob.engine == post.engine == "cuda"):
            fail(f"{fam} at the mega catalog takes {lnprob.engine} / "
                 f"{post.engine}, not the resident kernels")
        n0 = (getattr(cl, f"{fam}_lnlike").launches,
              getattr(cl, f"{fam}_lnlike_vg").launches)
        d_val = _dlnp_err(lnprob(th), want)
        d_vg = _dlnp_err(post(th), want)
        if (getattr(cl, f"{fam}_lnlike").launches - n0[0] != 1
                or getattr(cl, f"{fam}_lnlike_vg").launches - n0[1] != 1):
            fail(f"{fam}: the precision gate did not run through its "
                 "kernels")
        print(f"{fam} mega ({MEGA_SOURCES} sources, float64 run, float32 "
              f"kernels): lnp differences of 32 close pairs (|dlnp| "
              f"{float((want[32:] - want[:32]).abs().max()):.3f} at most) vs "
              f"float64 eager: max error {d_val:.4e} through "
              f"{fam}_lnlike, {d_vg:.4e} through {fam}_lnlike_vg's value "
              f"(limit {DLNP_TOL})")
        if not (d_val <= DLNP_TOL and d_vg <= DLNP_TOL):
            fail(f"{fam} mega: lnp difference error {d_val:.4e} (value "
                 f"kernel), {d_vg:.4e} (value+gradient kernel)")
        errs[f"{fam}_lnlike"], errs[f"{fam}_lnlike_vg"] = d_val, d_vg
    del ctx
    torch.cuda.empty_cache()
    return errs


def _near(m, w, gen, scale):
    """``w`` thetas around the truth, ``scale`` box widths apart."""
    return m.truth + scale * m.width * torch.randn(
        (w, m.truth.numel()), generator=gen, dtype=torch.float64,
        device=m.truth.device)


def phase_stream(dev, m):
    """The streaming kernels on the mega catalog ``m``: against their
    plain versions, the float64 eager engine and (lnp differences of close
    thetas) float64 itself; two launches on one input bit for bit; the sum
    of shards; times beside the resident kernels' at the same shape."""
    data, layout = m.data, m.layout
    lnprob = cl.make_cuda_lnprob(m.ctx, layout)
    post = cl.make_cuda_lnprob_and_grad(m.ctx, layout)
    if not (lnprob.engine == post.engine == "cuda-stream"):
        fail(f"the mega catalog takes {lnprob.engine} / {post.engine}, "
             "not the streaming kernels")
    resident = cl.prepare_cuda_data(m.ctx, False, m.cfg.fcmin,
                                    dtype=torch.float32)
    print(f"mega catalog: {MEGA_SOURCES} sources, "
          f"{int(data.g_a.numel())} cells, {lnprob.stream[1]} source tiles "
          f"of {cl.CHUNK_CELLS} ({data.s_logf.shape[1]} slots), "
          f"{int(data.runs.shape[0])} runs of up to {data.run_pieces} "
          f"tiles, waves of {data.waves[0]} / {data.waves[1]} blocks")

    def feats_of(th, d=data):
        return cl._features_stream(th, d, layout, torch.float32)

    summary = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0}
               for k in ("free_stream_lnlike", "free_stream_lnlike_vg")}
    rec = summary["free_stream_lnlike"]
    gen = torch.Generator(device=dev).manual_seed(1019)
    for w in (50, 51):
        th = _near(m, w, gen, 0.002)
        f = feats_of(th).float()
        got = cl.free_stream_lnlike(f, data)
        again = cl.free_stream_lnlike(f, data)
        ref = cl.free_stream_lnlike_reference(f, data)
        full = lnprob(th)
        want = _in_rows(m.eager64, th, 16)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"free_stream_lnlike mega W={w}: two launches on one "
                 "input differ")
        err_k, abs_k = _rel(got, ref), float((got - ref).abs().max())
        err_f = _rel(full, want)
        print(f"free_stream_lnlike mega W={w}: two launches bit-identical; "
              f"kernel vs plain max rel "
              f"{err_k:.3e}, max abs {abs_k:.3e} (|part| <= "
              f"{float(ref.abs().max()):.4e}); lnprob vs f64 eager "
              f"{err_f:.3e} (max abs {float((full - want).abs().max()):.4f}"
              f", |lnL| <= {float(want.abs().max()):.4e})")
        if not (torch.isfinite(got).all() and err_k <= RTOL_KERNEL
                and err_f <= RTOL_F64):
            fail(f"free_stream_lnlike mega W={w}: {err_k:.3e} vs plain, "
                 f"{err_f:.3e} vs f64 eager")
        rec["max_rel_err"] = max(rec["max_rel_err"], err_k)
        rec["max_abs_err"] = max(rec["max_abs_err"], abs_k)
    # the accept step's quantity: lnp differences of 32 close pairs
    th = _close_pairs(m.truth, m.width, gen)
    want = _in_rows(m.eager64, th, 16)
    fr = cl._features(th.float(), resident, layout, torch.float32).float()
    # post: the value column NUTS's accept step reads
    d_val, d_vg, d_res = (_dlnp_err(v, want) for v in (
        lnprob(th), post(th), cl.free_lnlike(fr, resident)))
    dlnp = want[32:] - want[:32]
    print(f"mega: lnp differences of 32 close pairs (|dlnp| "
          f"{float(dlnp.abs().min()):.3f} to "
          f"{float(dlnp.abs().max()):.3f}) vs float64: max error "
          f"{d_val:.4e} through free_stream_lnlike, {d_vg:.4e} through "
          f"free_stream_lnlike_vg's value (limit {DLNP_TOL}); the float32 "
          f"resident free_lnlike's {d_res:.4e}")
    if not (d_val <= DLNP_TOL and d_vg <= DLNP_TOL):
        fail(f"mega: lnp difference error {d_val:.4e} (value kernel), "
             f"{d_vg:.4e} (value+gradient kernel)")
    rec["dlnp_err"], rec["resident_dlnp_err"] = d_val, d_res
    summary["free_stream_lnlike_vg"]["dlnp_err"] = d_vg
    # two shards on the one card add up to the whole
    th = _near(m, 50, gen, 0.002)
    f1 = feats_of(th)
    whole = cl.free_stream_lnlike(f1.float(), data) + cl._stream_collapsed(
        f1, data)
    two = cl.prepare_cuda_stream_data(m.ctx, m.cfg.fcmin, nshards=2,
                                      dtype=torch.float32)
    f2 = feats_of(th, two)
    tot = sum(cl.free_stream_lnlike(f2.float(), two, k)
              + cl._stream_collapsed(f2, two, k) for k in range(2))
    err_sh = _rel(tot, whole)
    print(f"free_stream_lnlike mega: 2 shards vs 1, max rel {err_sh:.3e}")
    if not err_sh <= 1e-6:
        fail(f"free_stream_lnlike mega: 2 shards vs 1 {err_sh:.3e}")
    del two
    fw = f1.float()
    fr = cl._features(th.float(), resident, layout, torch.float32).float()
    ms = _device_ms(lambda: cl.free_stream_lnlike(fw, data), inner=10,
                    reps=9)
    pms = _device_ms(lambda: cl.free_stream_lnlike_reference(fw, data),
                     inner=3, reps=5)
    rms = _device_ms(lambda: cl.free_lnlike(fr, resident), inner=10, reps=9)
    cms = _call_ms(lambda: cl.free_stream_lnlike(fw, data))
    lms = _call_ms(lambda: lnprob(th), inner=20, reps=5)
    bms, by, nb, nops, ntr = _bound("free_stream_lnlike", data, 50)
    print(f"free_stream_lnlike mega W=50 device time: kernel "
          f"{ms * 1e3:.2f} us, plain {pms * 1e3:.2f} us, resident "
          f"free_lnlike {rms * 1e3:.2f} us; eager wrapper call "
          f"{cms * 1e3:.2f} us, whole lnprob call {lms * 1e3:.2f} us; "
          f"bound {bms * 1e3:.4f} us ({by}: {nb} bytes, {nops} f32 "
          f"operations, {ntr} transcendentals)")
    rec.update(ms=ms, plain_ms=pms, call_ms=cms, lnprob_call_ms=lms,
               bound_ms=bms, bound_by=by, trans=ntr, resident_ms=rms,
               shape=f"W=50, gauss-32 mega, {MEGA_SOURCES} sources")

    rec = summary["free_stream_lnlike_vg"]
    rec["max_grad_err"] = 0.0
    fr_vg = None
    for w in (1, 8, 256):
        th = _near(m, w, gen, 0.01)
        f = feats_of(th).float()
        got = cl.free_stream_lnlike_vg(f, data)
        again = cl.free_stream_lnlike_vg(f, data)
        ref = cl.free_stream_lnlike_vg_reference(f, data)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"free_stream_lnlike_vg mega W={w}: two launches on one "
                 "input differ")
        cols = [c for c in range(1, got.shape[1]) if c != 2]
        err_v = _rel(got[:, 0], ref[:, 0])
        err_g = _grad_rel(got[:, cols], ref[:, cols])
        t = th.clone().requires_grad_(True)
        v = post(t)
        (g,) = torch.autograd.grad(v.sum(), t)
        vals, grads = [], []
        for i in range(0, w, 32):
            ti = th[i:i + 32].clone().requires_grad_(True)
            vi = m.eager64(ti)
            grads.append(torch.autograd.grad(vi.sum(), ti)[0])
            vals.append(vi.detach())
        v64, g64 = torch.cat(vals), torch.cat(grads)
        err_tv = _rel(v.detach(), v64)
        err_tg = _grad_rel(g, g64)
        print(f"free_stream_lnlike_vg mega W={w}: two launches "
              f"bit-identical; kernel vs plain value max "
              f"rel {err_v:.3e}, gradient {err_g:.3e}; theta-level vs f64 "
              f"eager autograd value {err_tv:.3e}, gradient {err_tg:.3e}")
        if err_v > RTOL_KERNEL or err_g > RTOL_GRAD or not bool(
                (got[:, 2] == 0).all()):
            fail(f"free_stream_lnlike_vg mega W={w}: kernel vs plain "
                 f"{err_v:.3e} (value), {err_g:.3e} (gradient)")
        if err_tv > RTOL_F64 or err_tg > RTOL_GRAD:
            fail(f"free_stream_lnlike_vg mega W={w}: vs f64 eager autograd "
                 f"{err_tv:.3e} (value), {err_tg:.3e} (gradient)")
        rec["max_rel_err"] = max(rec["max_rel_err"], err_v)
        rec["max_grad_err"] = max(rec["max_grad_err"], err_g)
        if w == 1:
            continue
        if w == 8:
            rec["max_abs_err"] = float((got[:, 0] - ref[:, 0]).abs().max())
        fr_vg = cl._features(th.float(), resident, layout,
                             torch.float32).float()
        ms = _device_ms(lambda: cl.free_stream_lnlike_vg(f, data), inner=10,
                        reps=9)
        pms = _device_ms(lambda: cl.free_stream_lnlike_vg_reference(f, data),
                         inner=2, reps=5)
        rms = _device_ms(lambda: cl.free_lnlike_vg(fr_vg, resident),
                         inner=10, reps=9)
        bms, by, nb, nops, ntr = _bound("free_stream_lnlike_vg", data, w)
        print(f"free_stream_lnlike_vg mega W={w} device time: kernel "
              f"{ms * 1e3:.2f} us, plain {pms * 1e3:.2f} us, resident "
              f"free_lnlike_vg {rms * 1e3:.2f} us; bound {bms * 1e3:.4f} us "
              f"({by}: {nb} bytes, {nops} f32 operations, {ntr} "
              "transcendentals)")
        key = "" if w == 8 else f"_w{w}"
        rec.update({f"ms{key}": ms, f"plain_ms{key}": pms,
                    f"bound_ms{key}": bms, f"bound_by{key}": by,
                    f"trans{key}": ntr, f"resident_ms{key}": rms})
        if w == 8:
            rec["call_ms"] = _call_ms(lambda: cl.free_stream_lnlike_vg(
                f, data))
            rec["shape"] = f"W=8, gauss-32 mega, {MEGA_SOURCES} sources"
    del resident
    torch.cuda.empty_cache()
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


def _smoke_config(workdir, has_mpl, x64=False):
    """The fits' ``--config`` file: plots only where matplotlib is, and
    ``use_x64`` (a float64 lnprob) for the mega catalog."""
    cfg_path = os.path.join(workdir, f"smoke_config{'_x64' * x64}.json")
    od = dict(LFConfig().output_dict)
    od["triangle plot"] = has_mpl
    with open(cfg_path, "w") as fh:
        json.dump({"output_dict": od, **({"use_x64": True} if x64 else {})},
                  fh)
    return cfg_path


def _drive(argv, run_dir):
    """Run the port's CLI in ``run_dir`` with every launch counter set to
    0 just before; returns (rc, launches, log records, device memory
    peak, wall seconds), the counters read just after."""
    rec = _Records()
    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    log.addHandler(rec)
    cwd = os.getcwd()
    os.makedirs(run_dir)
    os.chdir(run_dir)
    try:
        for name in KERNELS:
            _kernel(name).launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        wall = time.perf_counter() - t0
        counts = {name: _kernel(name).launches for name in KERNELS}
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(cwd)
        log.removeHandler(rec)
    return rc, counts, rec, peak, wall


def _artifacts(label, out, base, has_mpl):
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
    return post


def _path(cmd, extra, out, fam, col, **kw):
    """A fit path: CLI arguments after the subcommand, output directory,
    the kernel family, the posterior column the NUTS run is held to, the
    catalog size, stretch steps, NUTS samples and whether it runs with
    ``use_x64``."""
    base = dict(nsynth=NSYNTH, nsteps=NSTEPS, nuts=NUTS_STEPS[fam],
                x64=False)
    return SimpleNamespace(cmd=cmd, extra=extra, out=out, fam=fam, col=col,
                           **{**base, **kw})


PATHS = {
    "fit": _path("fit", [], "LFMCMCOut", "free", r"$\log L_*$"),
    "fit -fc": _path("fit", ["-fc"], "LFMCMCOut", "fixed", r"$\log L_*$"),
    "fitz": _path("fitz", [], "LFMCMCzOut", "z", r"$\log {\rm{L}}2_*$"),
    "fith": _path("fith", [], "LFMCMCHOut", "hier", r"$\mu_{L_*}$"),
    "fit mega": _path("fit", ["--seed", str(MEGA_SEED), "--quadrature",
                              "gauss"], "LFMCMCOut", "free", r"$\log L_*$",
                      nsynth=MEGA_TARGET, nsteps=MEGA_STEPS,
                      nuts=NUTS_STEPS["mega"], x64=True),
}


def _route(path, rec, label):
    """The kernel name stem the path's catalog takes: the streaming one
    under free completeness from ``STREAM_MIN_SOURCES`` sources on (the
    count its log reports)."""
    (nsrc,) = _logged(rec, r"Context build: [\d.]+ s \((\d+) sources",
                      label)
    stream = path.fam == "free" and nsrc >= cl.STREAM_MIN_SOURCES
    if stream:
        want = (f"Engine: CUDA streaming kernels ({int(nsrc)} sources, ")
        if not any(ln.startswith(want) for ln in rec.lines):
            fail(f"{label}: the log does not name the streaming engine")
    return ("free_stream" if stream else path.fam), int(nsrc)


def _check_lf_matrix(label, out, base):
    """``fitz``'s bestfitLF: the LF matrix beside its axes."""
    tab = read_fixed_width_two_line(
        os.path.join(out, f"bestfitLF_{base}.dat"))
    cols = list(tab)
    if cols[:2] != ["Luminosity_cols", "Redshift_rows"] or cols[2:] != [
            f"LF_z{i}" for i in range(len(cols) - 2)] or len(cols) != 102:
        fail(f"{label}: bestfitLF columns {cols[:4]}... ({len(cols)})")
    lf = np.asarray([tab[c] for c in cols[2:]])
    if not (np.isfinite(lf).all() and (lf > 0).all()):
        fail(f"{label}: the LF matrix is not finite and positive")


def phase_fit(label, workdir, has_mpl):
    """The port's CLI, end to end, through the kernels. Returns the
    launch counts and the posterior's ``col`` column."""
    path = PATHS[label]
    argv = [path.cmd, "--synthetic", str(path.nsynth), "-mcf", "0.5",
            "-nw", str(NWALKERS), "-ns", str(path.nsteps), "--config",
            _smoke_config(workdir, has_mpl, path.x64)] + path.extra
    run_dir = os.path.join(workdir, label.replace(" ", "_"))
    rc, counts, rec, peak, wall = _drive(argv, run_dir)
    if rc != 0:
        fail(f"{label} returned {rc}")
    base = f"test_nb50_nw{NWALKERS}_ns{path.nsteps}_mcf50"
    out = os.path.join(run_dir, path.out)
    post = _artifacts(label, out, base, has_mpl)
    acc = rec.value("Mean acceptance fraction:")
    if not 0.1 < acc < 0.9:
        fail(f"{label}: acceptance fraction {acc} outside (0.1, 0.9)")
    stem, nsrc = _route(path, rec, label)
    used = f"{stem}_lnlike"
    want = {k: 0 for k in KERNELS}
    want[used] = 1 + 2 * path.nsteps
    if counts != want:
        fail(f"{label}: launch counts {counts}, expected {want}")
    col = np.asarray(post[path.col])
    extra = ""
    if path.x64:
        if not any(ln.startswith(DEVICE_LINE) and ln.endswith("float64")
                   for ln in rec.lines):
            fail(f"{label}: the run's dtype is not float64")
        if nsrc != MEGA_SOURCES:
            fail(f"{label}: {nsrc} sources, expected {MEGA_SOURCES}")
        # the stretch ensemble contracts ~100x from the prior box: its
        # posterior is the select_samples rows (as the parameters table's)
        names = list(post)
        sel = select_samples(np.column_stack([post[k] for k in names]))
        col = sel[:, names.index(path.col)]
        truth = LFConfig().Lstar
        if not abs(np.median(col) - truth) < 0.05:
            fail(f"{label}: logL* median {np.median(col):.4f}, truth "
                 f"{truth} (limit 0.05 dex)")
        extra = (f", {len(sel)} selected rows, their logL* median "
                 f"{np.median(col):.4f} (truth {truth}), sd "
                 f"{np.std(col):.5f}; {nsrc} sources")
    if path.fam == "z":
        _check_lf_matrix(label, out, base)
        # the middle pivots are the best constrained: they must constrain
        # (the JAX package's own bar, tests/test_end_to_end.py), over the
        # rows the parameters table is made of (select_samples: a walker
        # still far down the lnprob slope is no posterior draw)
        names = list(post)
        sel = select_samples(np.column_stack([post[k] for k in names]))
        sd_l2 = float(np.std(sel[:, names.index(path.col)]))
        sd_p2 = float(np.std(sel[:, names.index(r"$\log \phi2_*$")]))
        if not (sd_l2 < 0.8 and sd_p2 < 0.8):
            fail(f"{label}: posterior sd of L2 {sd_l2:.3f}, phi2 "
                 f"{sd_p2:.3f} (limit 0.8)")
        extra = (f", posterior sd L2 {sd_l2:.4f}, phi2 {sd_p2:.4f} over "
                 f"{len(sel)} selected rows (all rows: {np.std(col):.4f}, "
                 f"{np.std(np.asarray(post[names[4]])):.4f})")
    if path.fam == "hier":
        # fields drawn from one truth: the population mean and every
        # field's own logL* recover it (the JAX package's own bars,
        # tests/test_hierarchical.py)
        truth = LFConfig().Lstar
        nf = len(LFConfig().Flim)
        meds = [float(np.median(np.asarray(post[r"$\log L_{*,%d}$" % i])))
                for i in range(nf)]
        if len(post) != 5 + 2 * nf + 1:
            fail(f"{label}: {len(post)} posterior columns")
        if not abs(np.median(col) - truth) < 0.4:
            fail(f"{label}: mu_L median {np.median(col):.3f}, truth {truth}")
        if not all(abs(m - truth) < 0.5 for m in meds):
            fail(f"{label}: Lstar_f medians {meds}, truth {truth}")
        sig = np.asarray(post[r"$\sigma_{L_*}$"])
        extra = (f", Lstar_f medians {[round(m, 3) for m in meds]} (truth "
                 f"{truth}), sig_L median {np.median(sig):.4f}")
    print(f"{label}: artifacts ok ({len(col)} posterior rows), "
          f"acceptance {acc:.4f}, sampling loop "
          f"{rec.value('Total time taken:'):.3f} s, "
          f"{rec.value('lnprob evaluations/s:'):.1f} lnprob evals/s, "
          f"device memory peak {peak / 2**20:.1f} MiB, CLI wall "
          f"{wall:.1f} s, {used} launches {counts[used]}, median "
          f"{path.col} {np.median(col):.3f}{extra}")
    return counts, col


def _logged(rec, pattern, label):
    """The float groups of ``pattern`` in the last log line matching it."""
    for line in reversed(rec.lines):
        m = re.search(pattern, line)
        if m:
            return [float(g) for g in m.groups()]
    fail(f"{label}: no log line matches {pattern!r}")


def phase_nuts(stretch_label, workdir, has_mpl, stretch_col):
    """``--sampler nuts`` end to end through the value+gradient kernels,
    held to the stretch fit of the same catalog."""
    path = PATHS[stretch_label]
    nsteps = path.nuts
    argv = [path.cmd, "--sampler", "nuts", "--synthetic", str(path.nsynth),
            "-mcf", "0.5", "-ns", str(nsteps), "--nchains",
            str(NUTS_CHAINS), "--config",
            _smoke_config(workdir, has_mpl, path.x64)] + path.extra
    label = " ".join([path.cmd, "--sampler nuts"] + path.extra)
    run_dir = os.path.join(workdir, "nuts_" + stretch_label.replace(" ", "_"))
    rc, counts, rec, peak, wall = _drive(argv, run_dir)
    if rc != 0:
        fail(f"{label} returned {rc}")
    base = f"test_nb50_nw{NWALKERS}_ns{nsteps}_mcf50"
    out = os.path.join(run_dir, path.out)
    post = _artifacts(label, out, base, has_mpl)
    if path.fam == "z":
        _check_lf_matrix(label, out, base)
    secs, eps, accept, div_pct = _logged(
        rec, r"Total time taken: ([\d.]+) s; step size ([\d.e+-]+); mean "
        r"accept-stat ([\d.]+); divergent transitions ([\d.]+)%", label)
    ntrans, nlf, nsync, lf_mean, lf_max, lf_chain = _logged(
        rec, r"NUTS work: (\d+) transitions, (\d+) leapfrog steps "
        r"\(batched over \d+ chains\), (\d+) host syncs; leapfrogs per "
        r"transition: batched mean ([\d.]+), max (\d+), per chain mean "
        r"([\d.]+)", label)
    ess, rhat, ess_s = _logged(
        rec, r"min ESS: ([\d.]+); max R-hat: ([\d.]+); ESS/sec: ([\d.]+)",
        label)
    if ntrans != NUTS_WARMUP + nsteps:
        fail(f"{label}: {ntrans} transitions, expected "
             f"{NUTS_WARMUP + nsteps}")
    if not div_pct < 5.0:
        fail(f"{label}: {div_pct}% divergent transitions (limit 5%)")
    if not 0.6 < accept < 0.97:
        fail(f"{label}: mean accept-stat {accept} outside (0.6, 0.97)")
    if not rhat < 1.1:
        fail(f"{label}: max R-hat {rhat} (limit 1.1)")
    col = np.asarray(post[path.col])
    gap = abs(np.median(col) - np.median(stretch_col)) / np.std(col)
    if not gap < 3.0:
        fail(f"{label}: {path.col} median {np.median(col):.4f} is "
             f"{gap:.2f} posterior sd from the stretch fit's "
             f"{np.median(stretch_col):.4f} (limit 3)")
    fam, _ = _route(path, rec, label)
    rows = nsteps * NUTS_CHAINS
    want = {k: 0 for k in KERNELS}
    want[f"{fam}_lnlike_vg"] = int(ntrans + nlf)
    # the forward kernel: the start guard (one call) and the theta-space
    # Ln Prob recompute (one call per MAX_ROWS rows)
    want[f"{fam}_lnlike"] = 1 + math.ceil(rows / cl.MAX_ROWS)
    if counts != want:
        fail(f"{label}: launch counts {counts}, expected {want}")
    print(f"{label}: artifacts ok ({len(col)} posterior rows); median "
          f"{path.col} {np.median(col):.4f} vs stretch "
          f"{np.median(stretch_col):.4f} ({gap:.2f} sd); "
          f"{fam}_lnlike_vg launches {counts[f'{fam}_lnlike_vg']} = "
          f"{int(ntrans)} transitions + {int(nlf)} leapfrog steps; "
          f"{fam}_lnlike launches {counts[f'{fam}_lnlike']}")
    print(f"{label}: Total time taken {secs:.2f} s ({NUTS_WARMUP} warmup + "
          f"{nsteps} samples, {NUTS_CHAINS} chains)")
    print(f"{label}: ESS/s {ess / secs:.3f} (min ESS {ess:.0f} over "
          f"{secs:.2f} s; the log's rounded ESS/sec {ess_s:.0f}), max "
          f"R-hat {rhat:.4f}")
    print(f"{label}: step size {eps:.4g}, mean accept-stat {accept:.2f}, "
          f"divergent transitions {div_pct:.2f}%")
    print(f"{label}: leapfrogs per transition: batched mean {lf_mean:.2f}, "
          f"max {int(lf_max)}, per chain mean {lf_chain:.2f}; "
          f"{secs / (ntrans + nlf) * 1e3:.4f} ms per value+gradient call "
          f"(transitions + leapfrog steps); {int(nsync)} host syncs")
    print(f"{label}: device memory peak {peak / 2**20:.1f} MiB, CLI wall "
          f"{wall:.1f} s")
    return counts


def phase_vmax(workdir, has_mpl):
    """The standalone 1/V_eff pipeline on the fits' catalog, whole and in
    three equal-count z bins: weights and bootstrap on the card, the
    Schechter fit on the host. No kernel is on this path."""
    stem = "OIII_Vmax_LF_mcf_50_bins_50"
    for label, extra, stems in (
            ("vmax", [], [stem]),
            ("vmax --zbins 3", ["--zbins", "3"],
             [f"{stem}_zbin{b}" for b in range(3)])):
        argv = ["vmax", "--synthetic", str(NSYNTH), "-mcf", "0.5"] + extra
        run_dir = os.path.join(workdir, label.replace(" ", "_"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, counts, rec, peak, wall = _drive(argv, run_dir)
        text = out.getvalue()
        if rc != 0:
            fail(f"{label} returned {rc}")
        if any(counts.values()):
            fail(f"{label}: launch counts {counts}, expected none")
        if not any(ln.startswith(DEVICE_LINE) for ln in rec.lines):
            fail(f"{label}: the run was not given the card")
        img = os.path.join(run_dir, "ImageFiles", "Log")
        want = [f"{s}_log.dat" for s in stems]
        if has_mpl:
            want += [f"{s}_log.png" for s in stems]
            want += ["OIII_zevol_log.png"] if extra else []
        missing = [f for f in want if not os.path.isfile(
            os.path.join(img, f))]
        if missing:
            fail(f"{label}: missing artifacts {missing}")
        fits = re.findall(
            r"al\s+= (\S+) \+/- (\S+)\n\s+phistar\s+= (\S+) \+/- (\S+)\n"
            r"\s+Lstar\s+= (\S+) \+/- (\S+)", text)
        nconv = text.count("success            = True")
        if len(fits) != len(stems) or (not extra and nconv != 1):
            fail(f"{label}: {len(fits)} Schechter fits in the output, "
                 f"{nconv} converged, expected {len(stems)}")
        for s, fit in zip(stems, fits):
            tab = read_fixed_width_two_line(os.path.join(img, f"{s}_log.dat"))
            if list(tab) != ["Luminosity", "BinLF", "BinLFErr"]:
                fail(f"{label}: {s} columns {list(tab)}")
            lf, err = np.asarray(tab["BinLF"]), np.asarray(tab["BinLFErr"])
            if not (np.isfinite(lf).all() and (lf >= 0).all()
                    and (lf > 0).mean() > 0.8 and np.isfinite(err).all()
                    and (err > 0).all()):
                fail(f"{label}: {s}: BinLF is not finite and positive "
                     f"({(lf > 0).sum()} of {len(lf)} bins filled)")
            al, al_e, ph, ph_e, ls, ls_e = (float(v) for v in fit)
            # a z bin holds a third of the sources: alpha is known to
            # +-0.3 there and its optimum reaches the bound at 0 for some
            # bootstrap draws, where the LM stalls without its convergence
            # flag (as the JAX package's does), so only the whole-catalog
            # fit is held to the flag and off the alpha bound
            al_ok = -5.0 < al <= 0.0 if extra else -5.0 < al < 0.0
            if not (np.isfinite([al, al_e, ph, ph_e, ls, ls_e]).all()
                    and al_ok and 40.0 < ls < 45.0 and ph > -8.0):
                fail(f"{label}: {s}: Schechter fit al {al}, phistar {ph}, "
                     f"Lstar {ls} is on or outside its bounds")
            print(f"{label}: {s}: {(lf > 0).sum()} of {len(lf)} bins "
                  f"filled; Schechter fit al {al} +/- {al_e}, phistar {ph} "
                  f"+/- {ph_e}, Lstar {ls} +/- {ls_e}")
        print(f"{label}: artifacts ok ({len(want)} files), {nconv} of "
              f"{len(stems)} fits with the convergence flag, CLI wall "
              f"{wall:.2f} s, device memory peak {peak / 2**20:.1f} MiB")


def _check_no_jax():
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "lumfuncmcmc_tpu")]
    if bad:
        fail(f"the port imported {sorted(bad)[:5]}")


def run_path(label, workdir, has_mpl):
    """One fit path in this process: its stretch fit, then its NUTS fit.
    Prints their lines, then one JSON line with the path's launch counts
    (``python3 chip_smoke.py --path LABEL WORKDIR HAS_MPL``, which
    :func:`phase_paths` starts)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    counts, col = phase_fit(label, workdir, has_mpl)
    nuts = phase_nuts(label, workdir, has_mpl, col)
    _check_no_jax()
    print(json.dumps({"path": label, "launches": {
        k: counts[k] + nuts[k] for k in KERNELS}}))
    return 0


def phase_paths(workdir, has_mpl):
    """Every fit path of ``PATHS``, each in a process of its own, all
    started together. The sampler loops are paced by the host (the card
    is busy a few percent of a NUTS call), so side by side the paths take
    about the time of the longest, not the sum. Each process sets its
    launch counts to 0 before each fit and reads them after it; returns
    their sums over the paths."""
    procs = {}
    try:
        for label in PATHS:
            out = open(os.path.join(workdir, f"path_{len(procs)}.out"), "w+")
            procs[label] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--path", label,
                 workdir, str(int(has_mpl))], stdout=out), out)
        launches = {k: 0 for k in KERNELS}
        deadline = time.monotonic() + PATH_SECONDS
        for label, (proc, out) in procs.items():
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            out.seek(0)
            lines = out.read().splitlines()
            print("\n".join(lines[:-1]))
            if rc != 0:
                fail(f"the process of {label} returned {rc}")
            got = json.loads(lines[-1])
            if got["path"] != label:
                fail(f"{label}: the process reported {got['path']}")
            for k, v in got["launches"].items():
                launches[k] += v
    finally:
        for proc, out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    return launches


# kernel -> the TPU kernel(s) it replaces, file:line
REPLACES = {
    "free_lnlike": (f"{TPU_FILE}:601", f"{TPU_FILE}:761"),
    "fixed_lnlike": (f"{TPU_FILE}:751", f"{TPU_FILE}:813"),
    "free_lnlike_vg": (f"{TPU_FILE}:832",),
    "fixed_lnlike_vg": (f"{TPU_FILE}:1255",),
    "z_lnlike": (f"{TPU_FILE}:659", f"{TPU_FILE}:677"),
    "z_lnlike_vg": (f"{TPU_FILE}:1142",),
    "hier_lnlike": (f"{TPU_FILE}:713", f"{TPU_FILE}:734"),
    "hier_lnlike_vg": (f"{TPU_FILE}:1221",),
    "free_stream_lnlike": (f"{TPU_FILE}:941", f"{TPU_FILE}:404"),
    "free_stream_lnlike_vg": (f"{TPU_FILE}:1009", f"{TPU_FILE}:1711"),
    "roofline_chain": ("lumfuncmcmc_tpu/ops/pallas_roofline.py:59",),
}


def main():
    if sys.argv[1:2] == ["--path"]:
        return run_path(sys.argv[2], sys.argv[3], sys.argv[4] == "1")
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    dev = torch.device("cuda:0")
    roof, peak = phase_roofline(dev)
    summary = {"roofline_chain": roof}
    summary.update(phase_kernels(dev))
    summary.update(phase_vg_kernels(dev))
    mega = _mega_case(dev)
    summary.update(phase_stream(dev, mega))
    for name, err in phase_precision(dev, mega).items():
        summary[name]["dlnp_err"] = err
    del mega
    torch.cuda.empty_cache()
    print(f"kernel phases: {time.perf_counter() - t_start:.1f} s")
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_paths(workdir, has_mpl)
        phase_vmax(workdir, has_mpl)
    _check_no_jax()
    launches["roofline_chain"] = roof["launches"]
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was never launched on the main paths")
    kernels = []
    for name in KERNELS:
        s = summary[name]
        row = {
            "name": name, "route": "cuda", "source": _source(name),
            "replaces": REPLACES[name][0],
            "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "same_mix_ms": s["trans"] / peak * 1e3,
            "max_rel_err": s["max_rel_err"], "call_ms": s["call_ms"],
            "shape": s["shape"]}
        if len(REPLACES[name]) > 1:
            row["also_replaces"] = REPLACES[name][1]
        for k in ("max_grad_err", "ms_w256", "plain_ms_w256",
                  "bound_ms_w256", "ms_w1", "split", "split_w1",
                  "split_w256", "resident_ms", "resident_ms_w256",
                  "dlnp_err", "resident_dlnp_err", "lnprob_call_ms",
                  "elements_per_sec",
                  "transcendentals_per_sec"):
            if k in s:
                row[k] = s[k]
        if "trans_w256" in s:
            row["same_mix_ms_w256"] = s["trans_w256"] / peak * 1e3
        kernels.append(row)
    print(f"script time {time.perf_counter() - t_start:.1f} s")
    print(_SMI[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
