"""On-card smoke test of the PyTorch/CUDA port (``lumfuncmcmc_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (run as 1, 2, 10, 3, 4, 11, 13, 14, 19, then the fit paths, 16,
17 and 18 side by side, 15 and 9); any failure ends the run with a
nonzero exit:

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
   samples x 8 rows for its Ln Prob recompute), 13, and the calibration
   replicates' 16, 24, 32, 48 and 64 (``CALIB_WIDTHS``), with out-of-box
   thetas, a negative Flim (free), a row on the ``sch_al`` bound (z) and a
   ``sig_L = 0`` row (hier, in both ``fix_sch_al`` layouts); kernel and
   plain times; every value kernel is one launch a call (``ONE_LAUNCH``),
   also held to two launches on one input bit for bit, to its tickets back
   at 0, and at W = 50 to one kernel node a call (``torch.profiler``);
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
   (rtol 1e-5) at (256, 1024) and at (3, 1000), not a whole number of its
   blocks (its chains a thread, grid and registers printed), then its
   main path, ``transcendental_peak``, with the
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
   resident kernels' times at the same shape beside theirs (their tickets
   held back at 0 after every call);
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
   absolute, each error printed), each kernel's tickets back at 0;
14. the evidence ladder's likelihood: on the fits' catalog, for each
   family, ``run_tempered`` (16 rungs x 100 walkers x ``LADDER_STEPS``)
   through ``make_cuda_prior_like``'s ``lnlike_fn`` (its value kernel,
   one launch a half-step for all rungs, then the recompute in
   ``MAX_ROWS`` chunks: exact launch counts), then the same chains'
   post-burn lnlike by the float64 eager engine (the hierarchical data
   term without the hyperprior): the two stepping-stone ln Z within
   ``DLNP_TOL`` (0.05 nats), the tickets back at 0, each |dlnZ| and the
   ladder's wall time printed;
15. ``compare-ic`` on ``fit`` vs ``fit -fc`` (the same catalog) and
   ``stack-ic`` on both, from the paths' ``ic_pointwise`` files: a
   verdict, the stacked score, no launch;
16. the long-run drivers (the ``long`` path, :func:`run_long`) on the
   fits' catalog, each run with exact launch counts: ``fit
   --checkpoint-every 500 -ns 2000`` (4 x 1001 ``free_lnlike``), the same
   command on its npz cut at 2 blocks (2 x 1001; chain, lnprobability
   and acceptance bit for bit); ``fit --min-ess T -ns 500`` with T
   between the checkpointed chain's one- and two-block min ESS (B x 1001
   for B >= 2 blocks, the last at T; its blocks the checkpointed run's
   bit for bit); ``fit --ensembles 4`` (2 x 2000 + 1 launches, W = 200
   rows a half-step; cross-ensemble R-hat < 1.1, logL* within 3 sd of the
   checkpointed fit's); ``fith --ensembles 2 -ns 1000`` (2001
   ``hier_lnlike``); ``fit -fc --sampler nuts --checkpoint-every 100 -ns
   200`` and its resume from 1 block (bit for bit), ``--min-ess T2 -ns
   100`` (>= 2 blocks), with phase 6's NUTS gates and ``fixed_lnlike_vg``
   launches = transitions + leapfrogs; ``fit --exact-bounds`` (the eager
   engine, no launch, logL* within 3 sd of the frozen-bounds fit's);
   ``fit -ns 50 --profile DIR`` (a trace naming ``free_vg``);
17. the device grid (the ``grid`` path, :func:`run_grid`) on the fits'
   catalog at ``GRID_STEPS`` steps: a world of 1 under NCCL (``fit
   --mesh-walkers 1 --distributed 127.0.0.1:PORT,1,0``: 2 x steps + 1
   ``free_lnlike``, the plain fit's fitposterior byte for byte), the
   plain fit's evidence ladder and the meshless mega ``fit_model``; then
   two ranks on the one card (:func:`grid_rank`, a gloo group through
   ``init_distributed``, the collectives' CUDA tensors staged through the
   host; NCCL refuses two ranks on one device), each run's launch counts
   exact per rank: ``fit --mesh-walkers 2`` (W/4 rows a launch, the
   all_gather's share of the loop, logL* within 3 sd of the plain fit's,
   the grid's lnprob of 32 thetas vs meshless within ``RTOL_KERNEL``),
   the ladder on (2,1) (8 rungs a rank, |dlnZ| vs meshless within
   ``DLNP_TOL``), ``fith --ensembles 2 --mesh-walkers 2`` (one ensemble a
   rank) and the mega catalog on (1,2) (``free_stream_lnlike`` on source
   shards, the 32-close-pair gate through the sharded lnprob, each rank's
   memory peak beside the meshless one's); then NUTS on the grid, each run
   with exact per-rank launches (its vg kernel transitions + leapfrog
   steps, its value kernel the start guard and the Ln Prob recompute) and
   phase 6's gates (divergences < 5%, accept-stat in (0.6, 0.97), R-hat <
   1.1, logL* within 3 sd of the stretch fit's): the mega catalog's
   source-sharded streaming value+gradient of 8 thetas against the
   meshless one (values ``RTOL_KERNEL``, gradients ``RTOL_GRAD``) and its
   NUTS on (1,2) (``free_stream_lnlike_vg`` on source shards, the source
   group's host-staged ``all_reduce`` a call timed), the mega catalog's
   per-rank replicas on (2,1) checkpointed and resumed on a world of 1
   (bit for bit), the flagship's replicas (``free_lnlike_vg``) adapting
   alone and with ``--nuts-pooled`` (one step size), and ``fit -fc`` on
   the pooled route (``fixed_lnlike_vg``);
18. the calibration replicates (the ``calib`` path, :func:`run_calib`;
   ``lumfuncmcmc_tpu_torch/utils/calibration.py``) through the CUDA value
   kernels: each family's kernel on its first replicate's own data (gauss
   quadrature, the hierarchical model at 2 fields) at the replicates'
   widths against its plain version; ``tests/test_calibration.py``'s three
   ``-m slow`` gates at their K, sizes, seeds and bounds
   (``sbc_replicate`` K = 12, 32 x 400, ``size_ln`` 41, rng 7;
   ``coverage_replicate_z`` K = 8, rng 17; ``sbc_replicate_h`` K = 10, rng
   23) and ``coverage_replicate(free=True, pallas=True)`` twice with
   ``move="mix"`` and twice with ``init_map=True`` (finite chains inside
   the box, nine cover entries, which start ran), each replicate with
   exactly 2 x steps + 1 launches of its family's kernel and none of
   another, its wall and its setup/sampling split printed; and the five
   examples of ``lumfuncmcmc_tpu_torch/examples/`` (``quickstart`` and
   ``model_comparison`` at their own sizes, ``sbc_check 2``,
   ``coverage_check 2 --free --pallas``, ``coverage_check_z 2``), one
   after the other, each in a process of its own (``python3
   chip_smoke.py --example NAME ARGS``): exit code 0, its table, no JAX,
   its kernels' launches;
19. the public library API ("api", :func:`phase_api`): ``fleming``,
   ``inverse_fleming``, ``p_curve``, ``omega``, ``lum_at_flux``,
   ``efunc``, ``trapz_weights`` and ``gauss_legendre`` on float64 tensors
   on the card against the same calls on the CPU (rtol 1e-12; the deep
   faint tail of the completeness curve by its logarithm),
   ``build_cosmo_table(device="cuda")`` field for field
   ``build_cosmo_arrays``; then the flagship ``fit`` model through
   ``samplers.step``, 3 steps from a seeded generator with exactly 6
   ``free_lnlike`` launches and no other, bit for bit ``run_stretch``'s
   loop over the same draws (and one step ``run_stretch(nsteps=1)``), and
   ``VeffLF()`` the table of ``veff_lf()``; its wall printed.

Phases 5-8, 12, 16, 17 and 18 run side by side, each path in a process of
its own (``--path``): its stretch fit, its NUTS fit, then the model comparison
(``PATHS[label].compare``): the finished stretch fit rerun with ``--ic``
(every path; 1000 draws x 1,019,385 sources on the mega path), ``--ppc``
(``fit``, ``fitz``, ``fith``) and ``--evidence 16`` (``fit``; ``fith``
with ``--evidence-swap 10 --evidence-tune 1``), gated on the resumed
posterior, every artifact, the IC's decomposition error under the JAX
package's tolerance rule and a finite ``k_max``, the PPC's E[N_pred]
over the ``select_samples`` rows within 5 sqrt(N_obs) of N_obs (the
artifact's, over every row, printed beside it), and the ladder's exact
value-kernel launches (one a half-step for all rungs, plus the
recompute's chunks);
then ``fit -fc --map`` (the MAP's logL* within 3 posterior sd of the
stretch median, no launch) and a ``fit --init-map`` stretch fit. The
sampler loops are host-bound, so the five take about the time of the
longest. Each run has every launch counter set to 0 just before it and
read just after. Prints the kernel summary as one JSON line, then the
device line last.
"""

from __future__ import annotations

import contextlib
import functools
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
from lumfuncmcmc_tpu_torch.models.ensemble_driver import _EnsembleDriverMixin
from lumfuncmcmc_tpu_torch.models.hierarchical import (
    ThetaLayoutH, lnlike_h_split, make_lnprob_h)
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, lnlike_single_epoch, make_lnprob, sample_init)
from lumfuncmcmc_tpu_torch.models.likelihood_z import (
    ThetaLayoutZ, lnlike_z, make_lnprob_z)
from lumfuncmcmc_tpu_torch.models.model import select_samples
from lumfuncmcmc_tpu_torch.samplers.diagnostics import (
    effective_sample_size)
from lumfuncmcmc_tpu_torch.samplers.tempering import (
    beta_ladder, evidence_from_ladder, run_tempered)
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
ONE_LAUNCH = ("free_lnlike", "fixed_lnlike", "z_lnlike", "hier_lnlike",
              "free_lnlike_vg", "fixed_lnlike_vg", "z_lnlike_vg",
              "hier_lnlike_vg")
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
EVIDENCE_RUNGS = 16     # --evidence's rungs on the fit paths
LADDER_STEPS = 400      # phase 14's ladder steps (the CLI's: the fit's -ns)
SOURCES = {"z": "lnlike_z.cu", "hier": "lnlike_h.cu",
           "fixed": "lnlike_h.cu",
           "free_stream": "lnlike_stream.cu", "roofline": "roofline.cu"}
# The card's peaks for the bound (H100 SXM at 700 W): float32 outside the
# tensor cores, and HBM.
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
# float32 operations per cell evaluation (an FMA is 2, each
# exp/log/rsqrt/div/max/compare 1; fcmin > 0), counted from csrc/lnlike.cu:
# free_lnlike's grid cell 23 and unmasked source 23 (a masked one 1),
# free_lnlike_vg's grid cell 46 and unmasked source 45; from
# csrc/lnlike_h.cu: fixed_lnlike's grid cell 8, fixed_lnlike_vg's 12.
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
    # a streaming kernel reads its run table, which sets what it computes
    # (each shard's runs); a one-launch kernel's piece tables are its
    # implementation's, not the function's
    table = data.runs.numel() if stream else 0
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
    times (``torch.profiler``), which must be one node; fails otherwise.
    A capture with no CUDA event is retaken once."""
    kus = _kernel_us(fn)
    if not kus:
        # no CUDA event at all is the instrument's failure, not a kernel
        # node count: one retake, and two empty captures in a row fail
        print(f"{kname} {grid} W={w}: torch.profiler captured no CUDA "
              "event; retaking the capture once")
        kus = _kernel_us(fn)
        if not kus:
            fail(f"{kname} {grid} W={w}: two torch.profiler captures in a "
                 "row held no CUDA event")
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
    and cells the fits give it. Each case carries its kernel's name, grid,
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
        for w in (50, NWALKERS, 13, NUTS_CHAINS, case.steps * NUTS_CHAINS,
                  *CALIB_WIDTHS):
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
    """``roofline_chain`` against its plain version at (256, 1024) and
    at (3, 1000), its layout printed, then its main path,
    ``transcendental_peak``, with the launch counter set to 0 just before
    and read just after. Returns the kernel's summary row and the
    measured rate."""
    gen = torch.Generator(device=dev).manual_seed(15)
    errs = {}
    for shape in ((256, 1024), (3, 1000)):
        x = 0.05 + 0.9 * torch.rand(shape, generator=gen, device=dev)
        got = rl.roofline_chain(x, 8)
        ref = rl.roofline_chain_reference(x, 8)
        torch.cuda.synchronize()
        err, rel = float((got - ref).abs().max()), _rel(got, ref)
        errs[shape] = err, rel
        lay = rl.kernel_layout(x.numel())
        print(f"roofline_chain {shape} x 8 iterations: kernel vs plain max "
              f"abs {err:.3e}, max rel {rel:.3e}; E = "
              f"{lay['chains_per_thread']} chains a thread, grid "
              f"{lay['blocks']} x {lay['threads']} on {lay['sms']} SMs "
              f"({lay['blocks_per_sm']} resident an SM), "
              f"{lay['registers']} registers, {lay['local_bytes']} local "
              f"bytes a thread")
        if not (torch.isfinite(got).all() and rel <= 1e-5):
            fail(f"roofline_chain {shape} vs plain {rel:.3e} > 1e-5")
    err, rel = errs[(256, 1024)]
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


def _tickets_at_0(what, data):
    """Fails unless the one-launch kernels left ``data``'s tickets at 0."""
    torch.cuda.synchronize()
    if data.vg_tickets.any():
        fail(f"{what}: tickets not back at 0")


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
        _tickets_at_0(f"{fam}_lnlike mega", lnprob.data)
        _tickets_at_0(f"{fam}_lnlike_vg mega", post.data)
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
    _tickets_at_0("free_lnlike mega", resident)
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
    _tickets_at_0("free_lnlike mega, timed", resident)
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
        _tickets_at_0(f"free_lnlike_vg mega W={w}, timed", resident)
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
    # the paths' processes share the file: each writes its own copy and
    # renames it in, so no reader ever sees it half written
    tmp = f"{cfg_path}.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"output_dict": od, **({"use_x64": True} if x64 else {})},
                  fh)
    os.replace(tmp, cfg_path)
    return cfg_path


def _drive(argv, run_dir):
    """Run the port's CLI in ``run_dir`` with every launch counter set to
    0 just before; returns (rc, launches, log records, device memory
    peak, wall seconds), the counters read just after."""
    rec = _Records()
    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    log.addHandler(rec)
    cwd = os.getcwd()
    os.makedirs(run_dir, exist_ok=True)
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


def _path(cmd, extra, out, fam, col, compare, **kw):
    """A fit path: CLI arguments after the subcommand, output directory,
    the kernel family, the posterior column the NUTS run is held to, the
    model-comparison flags its finished stretch fit is rerun with, the
    catalog size, stretch steps, NUTS samples, whether it runs with
    ``use_x64``, and its fresh ``--map`` / ``--init-map`` run (``also``)."""
    base = dict(nsynth=NSYNTH, nsteps=NSTEPS, nuts=NUTS_STEPS[fam],
                x64=False, also=None)
    return SimpleNamespace(cmd=cmd, extra=extra, out=out, fam=fam, col=col,
                           compare=compare, **{**base, **kw})


EVIDENCE = ["--evidence", str(EVIDENCE_RUNGS)]
PATHS = {
    "fit": _path("fit", [], "LFMCMCOut", "free", r"$\log L_*$",
                 ["--ic", "--ppc"] + EVIDENCE, also="--init-map"),
    "fit -fc": _path("fit", ["-fc"], "LFMCMCOut", "fixed", r"$\log L_*$",
                     ["--ic"], also="--map"),
    "fitz": _path("fitz", [], "LFMCMCzOut", "z", r"$\log {\rm{L}}2_*$",
                  ["--ic", "--ppc"]),
    "fith": _path("fith", [], "LFMCMCHOut", "hier", r"$\mu_{L_*}$",
                  ["--ic", "--ppc"] + EVIDENCE + ["--evidence-swap", "10",
                                                  "--evidence-tune", "1"]),
    "fit mega": _path("fit", ["--seed", str(MEGA_SEED), "--quadrature",
                              "gauss"], "LFMCMCOut", "free", r"$\log L_*$",
                      ["--ic"], nsynth=MEGA_TARGET, nsteps=MEGA_STEPS,
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


def _fit_argv(path, workdir, has_mpl):
    """The stretch fit's command line of ``path``."""
    return [path.cmd, "--synthetic", str(path.nsynth), "-mcf", "0.5",
            "-nw", str(NWALKERS), "-ns", str(path.nsteps), "--config",
            _smoke_config(workdir, has_mpl, path.x64)] + path.extra


def _run_dir(workdir, label):
    return os.path.join(workdir, label.replace(" ", "_"))


def phase_fit(label, workdir, has_mpl):
    """The port's CLI, end to end, through the kernels. Returns the
    launch counts and the posterior's ``col`` column."""
    path = PATHS[label]
    argv = _fit_argv(path, workdir, has_mpl)
    run_dir = _run_dir(workdir, label)
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


def _ladder_launches(rec, label):
    """The value-kernel launches the log's evidence ladder makes: each
    leg one for the start and one a half-step over all rungs, then the
    lnlike recompute of the main leg's chain in ``MAX_ROWS`` chunks."""
    nr, nw, nsteps = _logged(
        rec, r"Evidence ladder: (\d+) rungs x (\d+) walkers x (\d+) steps",
        label)
    swap = [ln for ln in rec.lines
            if ln.startswith("Replica-exchange swap acceptance")]
    if swap:
        m = re.search(r"--evidence-swap (\d+)", " ".join(PATHS[label].compare))
        nsteps -= nsteps % int(m.group(1))
    tune = [int(re.search(r"\((\d+) steps\)", ln).group(1))
            for ln in rec.lines if ln.startswith("Ladder tuning leg")]
    return (sum(1 + 2 * n for n in tune) + 1 + 2 * int(nsteps)
            + math.ceil(nr * nsteps * nw / cl.MAX_ROWS)), tune


def _ppc_selected(path, out, base):
    """The posterior predictive check of ``path``'s stretch posterior
    over its ``select_samples`` rows (the rows of the parameters table,
    the IC and the path gates), on ``_write_ppc``'s trapz-201 grid of the
    fits' catalog, on the card: (E[N_pred], N_obs, rows, the largest gap
    of a walker's median lnprob below the best walker's). The artifact
    draws from every post-burn row, as the JAX CLI's does, and a stretch
    walker left in a far local mode is no posterior draw."""
    from lumfuncmcmc_tpu_torch.cli.common import _pivot_z
    from lumfuncmcmc_tpu_torch.models.ppc import posterior_predictive_check
    post = read_fixed_width_two_line(os.path.join(out,
                                                  f"fitposterior_{base}.dat"))
    rows = select_samples(np.column_stack([post[k] for k in post]))
    med = np.median(np.asarray(post["Ln Prob"]).reshape(-1, NWALKERS),
                    axis=0)
    cfg = LFConfig(min_comp_frac=0.5)
    cat = apply_completeness_cut(
        make_catalog(cfg, n_target=path.nsynth, seed=cfg.seed), cfg)
    if path.fam == "z":
        cfg = _pivot_z(cfg, None)
    fine = cfg.replace(fix_comp=path.fam != "free", size_ln=201,
                       quadrature="trapz")
    _, ctx = build_context(fine, z=cat["z"], flux=cat["flux"],
                           flux_e=cat["flux_e"], field_id=cat["field_id"],
                           device=torch.device("cuda:0"),
                           dtype=torch.float32)
    layout = {"z": ThetaLayoutZ, "hier": ThetaLayoutH}.get(
        path.fam, ThetaLayout).from_config(fine)
    res = posterior_predictive_check(rows, ctx, layout, nbins=cfg.nbins,
                                     seed=cfg.seed)
    return (res["total_predicted"], float(res["total_observed"]), len(rows),
            float(med.max() - med.min()))


def phase_compare(label, workdir, has_mpl):
    """The path's finished stretch fit rerun with its model-comparison
    flags (``PATHS[label].compare``): the resumed posterior, not sampled
    again; every artifact; the IC's decomposition error under the JAX
    package's tolerance rule and a finite ``k_max``; the PPC's expected
    total within 5 sqrt(N_obs) of the observed; the evidence ladder's
    value-kernel launches exactly one a half-step for all rungs plus the
    recompute's chunks, and a finite ln Z. Returns the launch counts.
    The PPC gate reads the check over the ``select_samples`` rows
    (:func:`_ppc_selected`) and prints the artifact's beside it."""
    path = PATHS[label]
    argv = _fit_argv(path, workdir, has_mpl) + path.compare
    name = f"{label} {' '.join(path.compare)}"
    run_dir = _run_dir(workdir, label)
    rc, counts, rec, peak, wall = _drive(argv, run_dir)
    if rc != 0:
        fail(f"{name} returned {rc}")
    if any(ln.startswith("Fitting ") for ln in rec.lines):
        fail(f"{name}: sampled again instead of resuming the posterior")
    base = f"test_nb50_nw{NWALKERS}_ns{path.nsteps}_mcf50"
    out = os.path.join(run_dir, path.out)
    want = {k: 0 for k in KERNELS}
    notes = []
    files = []
    if "--ic" in path.compare:
        files += [f"ic_{base}.dat", f"ic_pointwise_{base}.npz"]
    if "--ppc" in path.compare:
        files += [f"ppc_{base}.dat"] + ([f"ppc_{base}.png"] if has_mpl
                                        else [])
    if "--evidence" in path.compare:
        files += [f"evidence_{base}.dat"]
    missing = [f for f in files if not os.path.isfile(os.path.join(out, f))]
    if missing:
        fail(f"{name}: missing artifacts {missing}")
    if "--ic" in path.compare:
        nsrc, ndraws = _logged(rec, r"Predictive information criteria "
                               r"\((\d+) sources, (\d+) posterior draws\)",
                               name)
        (err,) = _logged(rec, r"decomposition check: max rel err "
                         r"([\d.e+-]+)", name)
        tol = 1e-5 if path.x64 else max(1e-4, 3e-7 * math.sqrt(nsrc))
        ic = read_fixed_width_two_line(os.path.join(out, f"ic_{base}.dat"))
        kmax = float(np.asarray(ic["k_max"])[0])
        if not (err <= tol and np.isfinite(kmax)):
            fail(f"{name}: IC decomposition error {err} (limit {tol:.2e}), "
                 f"k_max {kmax}")
        (secs,) = _logged(rec, r"Information criteria: ([\d.]+) s", name)
        notes.append(
            f"IC {int(ndraws)} draws x {int(nsrc)} sources in {secs:.2f} s "
            f"(elpd_loo {float(np.asarray(ic['elpd_loo'])[0]):.3f}, k_max "
            f"{kmax:.3f}, frac k>0.7 "
            f"{float(np.asarray(ic['frac_k_gt_07'])[0]):.4f}, decomposition "
            f"error {err:.2e} of {tol:.2e})")
    if "--ppc" in path.compare:
        ppc = read_fixed_width_two_line(os.path.join(out, f"ppc_{base}.dat"))
        nobs = float(np.sum(ppc["Observed"]))
        npred = float(np.sum(ppc["PredMean"]))
        sel_pred, sel_obs, nrows, gap = _ppc_selected(path, out, base)
        if not (sel_obs == nobs
                and abs(sel_pred - nobs) < 5.0 * math.sqrt(nobs)):
            fail(f"{name}: PPC E[N_pred] {sel_pred:.1f} over the selected "
                 f"rows vs N_obs {nobs:.0f} (limit 5 sqrt(N_obs))")
        (secs,) = _logged(rec, r"Posterior predictive check: ([\d.]+) s",
                          name)
        notes.append(f"PPC E[N_pred] {sel_pred:.1f} over the {nrows} "
                     f"selected rows vs N_obs {nobs:.0f} (the artifact's, "
                     f"over all rows, {npred:.1f}; the lowest walker's "
                     f"median lnprob {gap:.1f} below the best's) in "
                     f"{secs:.2f} s, worst bin p-value "
                     f"{float(np.min(ppc['PValue'])):.3f}")
    if "--evidence" in path.compare:
        stem, _ = _route(path, rec, name)
        want[f"{stem}_lnlike"], tune = _ladder_launches(rec, label)
        lnz, lnz_err, ti, secs = _logged(
            rec, r"ln Z = ([\d.e+-]+) \+- ([\d.e+-]+) \(stepping-stone; TI "
            r"([\d.e+-]+) .* in ([\d.]+) s", name)
        if not np.isfinite([lnz, lnz_err]).all():
            fail(f"{name}: ln Z {lnz} +- {lnz_err}")
        notes.append(f"ladder ln Z {lnz:.3f} +- {lnz_err:.3f} (TI {ti:.3f}) "
                     f"in {secs:.2f} s, {want[f'{stem}_lnlike']} "
                     f"{stem}_lnlike launches"
                     + (f" (tuning legs of {tune} steps)" if tune else ""))
    if counts != want:
        fail(f"{name}: launch counts {counts}, expected {want}")
    print(f"{name} (resumed): artifacts ok ({len(files)} files); "
          + "; ".join(notes) + f"; CLI wall {wall:.1f} s, device memory "
          f"peak {peak / 2**20:.1f} MiB")
    return counts


def phase_also(label, workdir, has_mpl, stretch_col):
    """The path's fresh ``--map`` run (no sampling: the MAP of the eager
    float64 lnpost, its logL* within 3 posterior sd of the stretch fit's
    median, no kernel launch) or ``--init-map`` stretch fit (Laplace
    starts, or the uniform fallback at a boundary mode; artifacts and
    launches as the stretch fit's). Returns the launch counts."""
    path = PATHS[label]
    flag = path.also
    name = f"{label} {flag}"
    run_dir = _run_dir(workdir, f"{label} {flag}")
    argv = _fit_argv(path, workdir, has_mpl) + [flag]
    rc, counts, rec, peak, wall = _drive(argv, run_dir)
    if rc != 0:
        fail(f"{name} returned {rc}")
    base = f"test_nb50_nw{NWALKERS}_ns{path.nsteps}_mcf50"
    out = os.path.join(run_dir, path.out)
    want = {k: 0 for k in KERNELS}
    lnpost, secs = _logged(rec, r"MAP fit: lnpost=([\d.e+-]+) in ([\d.]+) s",
                           name)
    if flag == "--map":
        tab = read_fixed_width_two_line(os.path.join(out, f"map_{base}.dat"))
        lstar = float(np.asarray(tab["Lstar"])[0])
        gap = abs(lstar - np.median(stretch_col)) / np.std(stretch_col)
        if not (np.isfinite(lnpost) and gap < 3.0):
            fail(f"{name}: MAP lnpost {lnpost}, logL* {lstar:.4f} is "
                 f"{gap:.2f} posterior sd from the stretch median "
                 f"{np.median(stretch_col):.4f} (limit 3)")
        if any(f.startswith("fitposterior") for f in os.listdir(out)):
            fail(f"{name}: sampled")
        lnz = float(np.asarray(tab["lnz_laplace"])[0])
        detail = (f"MAP lnpost {lnpost:.4f} in {secs:.2f} s, logL* "
                  f"{lstar:.4f} ({gap:.2f} sd from the stretch median), "
                  f"Laplace ln Z {lnz:.3f}")
    else:
        _artifacts(name, out, base, has_mpl)
        acc = rec.value("Mean acceptance fraction:")
        if not 0.1 < acc < 0.9:
            fail(f"{name}: acceptance fraction {acc} outside (0.1, 0.9)")
        laplace = any(ln.startswith("Walker init: ") for ln in rec.lines)
        fallback = any("using uniform box starts" in ln for ln in rec.lines)
        if laplace == fallback:
            fail(f"{name}: the log names neither the Laplace starts nor "
                 "their fallback")
        want[f"{path.fam}_lnlike"] = 1 + 2 * path.nsteps
        detail = (f"MAP lnpost {lnpost:.4f} in {secs:.2f} s, "
                  + ("Laplace starts" if laplace else
                     "uniform fallback (mode on a box edge)")
                  + f", acceptance {acc:.4f}, sampling loop "
                  f"{rec.value('Total time taken:'):.3f} s")
    if counts != want:
        fail(f"{name}: launch counts {counts}, expected {want}")
    print(f"{name}: ok; {detail}; CLI wall {wall:.1f} s")
    return counts


def phase_ic_commands(workdir):
    """``compare-ic`` on ``fit`` vs ``fit -fc`` (the same catalog), then
    ``stack-ic`` on both: they read only the paths' ``ic_pointwise``
    files and launch no kernel."""
    base = f"test_nb50_nw{NWALKERS}_ns{NSTEPS}_mcf50"
    npz = [os.path.join(_run_dir(workdir, label), PATHS[label].out,
                        f"ic_pointwise_{base}.npz")
           for label in ("fit", "fit -fc")]
    for argv, want in ((["compare-ic"] + npz, "paired sources"),
                       (["stack-ic"] + npz, "stacked log score")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, counts, _, _, wall = _drive(argv, os.path.join(workdir,
                                                               argv[0]))
        text = out.getvalue()
        if rc != 0 or want not in text or any(counts.values()):
            fail(f"{argv[0]}: rc {rc}, launches {counts}, output {text!r}")
        if argv[0] == "compare-ic" and not re.search(
                r"is preferred|no significant preference", text):
            fail(f"compare-ic printed no verdict: {text!r}")
        print(f"{argv[0]} fit vs fit -fc ({wall:.2f} s):")
        print("\n".join("  " + ln for ln in text.rstrip().splitlines()))


def phase_ladder(dev):
    """The ladder's likelihood (phase 14): on the fits' catalog, each
    family's ``run_tempered`` through ``make_cuda_prior_like``'s
    ``lnlike_fn`` on the card (float32 kernels, one launch a half-step),
    then the same chains' post-burn lnlike recomputed by the float64
    eager engine (the hierarchical data term without the hyperprior):
    the stepping-stone ln Z of the two within ``DLNP_TOL``, the kernel's
    launches exactly one a half-step plus the recompute's chunks, its
    tickets back at 0. Returns {family: |dlnZ|}."""
    base = LFConfig(min_comp_frac=0.5)
    cat = apply_completeness_cut(
        make_catalog(base, n_target=NSYNTH, seed=base.seed), base)
    kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
              field_id=cat["field_id"], device=dev)
    fixed = base.replace(fix_comp=True)
    eager = {"free": lnlike_single_epoch, "fixed": lnlike_single_epoch,
             "z": lnlike_z,
             "hier": lambda th, ctx, lay: lnlike_h_split(th, ctx, lay)[0]}
    betas = beta_ladder(EVIDENCE_RUNGS)
    out = {}
    for fam, cfg in (("free", base), ("fixed", fixed), ("z", fixed),
                     ("hier", fixed)):
        ctx32, ctx64 = (build_context(cfg, dtype=dt, **kw)[1]
                        for dt in (torch.float32, torch.float64))
        layout = {"z": ThetaLayoutZ, "hier": ThetaLayoutH}.get(
            fam, ThetaLayout).from_config(cfg)
        model = fam if fam in ("z", "hier") else "single"
        prior, like = cl.make_cuda_prior_like(ctx32, layout, model)
        kernel = _kernel(f"{fam}_lnlike")
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        pos0 = torch.stack([sample_init(gen, layout, NWALKERS,
                                        dtype=torch.float32, device=dev)
                            for _ in range(EVIDENCE_RUNGS)])
        n0 = kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chains, lnls, _ = run_tempered(prior, like, pos0, betas, gen,
                                       LADDER_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _tickets_at_0(f"{fam} ladder", like.data)
        rows = EVIDENCE_RUNGS * LADDER_STEPS * NWALKERS
        want = 1 + 2 * LADDER_STEPS + math.ceil(rows / cl.MAX_ROWS)
        if kernel.launches - n0 != want:
            fail(f"{fam} ladder: {kernel.launches - n0} {fam}_lnlike "
                 f"launches, expected {want}")
        burn = LADDER_STEPS // 2
        post = chains[:, burn:].double()
        with torch.no_grad():
            l64 = _in_rows(lambda th: eager[fam](th, ctx64, layout),
                           post.reshape(-1, layout.ndim),
                           1024 if fam == "free" else 256)
        l64 = l64.reshape(post.shape[:3]).cpu().numpy()
        l32 = lnls[:, burn:].double().cpu().numpy()
        z32 = evidence_from_ladder(l32, betas, burn_frac=0.0)["lnz_ss"]
        z64 = evidence_from_ladder(l64, betas, burn_frac=0.0)["lnz_ss"]
        d = abs(z32 - z64)
        if not d <= DLNP_TOL:
            fail(f"{fam} ladder: stepping-stone ln Z {z32:.4f} through the "
                 f"kernel vs {z64:.4f} float64 eager (|d| {d:.4f}, limit "
                 f"{DLNP_TOL})")
        print(f"{fam} ladder ({EVIDENCE_RUNGS} rungs x {NWALKERS} walkers x "
              f"{LADDER_STEPS} steps): ln Z {z32:.4f} through {fam}_lnlike, "
              f"{z64:.4f} float64 eager, |dlnZ| {d:.2e}; ladder wall "
              f"{wall:.2f} s, {want} launches (largest per-row |dlnl| "
              f"{np.max(np.abs(l32 - l64)):.3e})")
        out[fam] = d
        del chains, lnls, post, ctx32, ctx64
        torch.cuda.empty_cache()
    return out


RTOL_API = 1e-12     # the library functions, CUDA float64 vs CPU float64
API_STEPS = 3        # samplers.step calls of the "api" phase


def _api_close(name, got, want, fraction=False):
    """``got`` (on the card) against ``want`` (CPU) at ``RTOL_API``. A
    completeness ``fraction`` is held so from 1e-30 of its largest value
    up; below that, where fc ** (1 / (1 - exp(-f/f_tau))) raises fc to a
    power in the hundreds and one ulp of exp moves the value by ~1e-11,
    by its logarithm at ``RTOL_API``, values under the smallest normal on
    either side counting as 0. Returns the largest relative error."""
    got = got.detach().cpu().double().numpy() if torch.is_tensor(got) \
        else np.asarray(got, dtype=np.float64)
    want = want.detach().double().numpy() if torch.is_tensor(want) \
        else np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        fail(f"api: {name}: shape {got.shape}, expected {want.shape}")
    tiny = np.finfo(np.float64).tiny
    big = np.abs(want) >= (1e-30 * np.abs(want).max() if fraction else 0.0)
    err = np.abs(got - want)[big] / np.maximum(np.abs(want[big]), tiny)
    worst = float(err.max()) if err.size else 0.0
    if fraction:
        tail = ~big & (want >= tiny)
        lg = np.abs(np.log(got[tail]) - np.log(want[tail])) / np.abs(
            np.log(want[tail]))
        worst = max(worst, float(lg.max()) if lg.size else 0.0)
        if not np.array_equal(got[~big] < tiny, want[~big] < tiny):
            fail(f"api: {name}: an underflow on one side only")
    if not worst <= RTOL_API:
        fail(f"api: {name}: largest relative error {worst:.3e} on the card "
             f"vs the CPU (limit {RTOL_API})")
    return worst


def _api_functions(dev):
    """The library functions added with the public API (completeness,
    Omega, quadrature, cosmology) on float64 tensors on the card against
    the same calls on the CPU; returns {name: largest relative error}."""
    from lumfuncmcmc_tpu_torch import cosmology as cos
    from lumfuncmcmc_tpu_torch import ops
    from lumfuncmcmc_tpu_torch.ops import quadrature as quad
    from lumfuncmcmc_tpu_torch.ops.completeness import min_flux_p_curve
    from lumfuncmcmc_tpu_torch.ops.omega import lum_at_flux
    cpu = torch.device("cpu")
    rng = np.random.default_rng(16)
    f = 10.0 ** rng.uniform(-19, -14, size=4096)
    z = rng.uniform(1.9, 2.4, size=4096)
    logL = rng.uniform(41.5, 43.5, size=4096)
    f50 = 10.0 ** rng.uniform(-17.5, -16.5, size=64)
    alpha = rng.uniform(2.0, 6.0, size=64)
    on = {d: {k: torch.tensor(v, dtype=torch.float64, device=d)
              for k, v in (("f", f), ("z", z), ("logL", logL),
                           ("f50", f50), ("alpha", alpha))}
          for d in (dev, cpu)}
    tabs = {d: cos.build_cosmo_table(3.0, dtype=torch.float64, device=d)
            for d in (dev, cpu)}
    calls = {
        "fleming": (lambda d, t: [ops.fleming(t["f"], *c) for c in (
            (3.0e-17, 3.5, 0.1), (2.72e-17, 4.56, 0.1), (5.0e-17, 2.0, 0.3),
            (1.0e-17, 6.5, 0.05), (3.0e-17, 3.5, 0), (3.0e-17, None))],
            True),
        "inverse_fleming": (lambda d, t: [ops.inverse_fleming(
            t["f50"], t["alpha"], c) for c in (0.1, 0.2, 0.7)], False),
        "p_curve": (lambda d, t: [ops.p_curve(t["f"], 3e-17, a)
                                  for a in (-3.5, -2.0, 3.5)], False),
        "omega": (lambda d, t: [ops.omega(t["logL"], t["z"], tabs[d], *c)
                                for c in ((1.0e5, -16.5, 3.5, 0.1),
                                          (2.0e4, -16.6, 4.56, 0.0))], True),
        "lum_at_flux": (lambda d, t: [lum_at_flux(t["f"], t["z"], tabs[d])],
                        False),
        "efunc": (lambda d, t: [cos.efunc(t["z"])], False),
        "trapz_weights": (lambda d, t: [quad.trapz_weights(n, device=d)
                                        for n in (2, 101, 201)], False),
        "gauss_legendre": (lambda d, t: [*quad.gauss_legendre(32, device=d),
                                         *quad.gauss_legendre(64, 0.05, 3.0,
                                                              device=d)],
                           False),
    }
    errs = {}
    for name, (fn, fraction) in calls.items():
        got, want = fn(dev, on[dev]), fn(cpu, on[cpu])
        for g in got:
            if g.device.type != dev.type or g.dtype != torch.float64:
                fail(f"api: {name} gave {g.dtype} on {g.device}")
        errs[name] = max(_api_close(name, g, w, fraction)
                         for g, w in zip(got, want))
    for mcf in (0.0, 0.2, 0.5, 0.8):
        if not min_flux_p_curve(mcf, 3e-17, -3.5) >= 0.0:
            fail(f"api: min_flux_p_curve({mcf}) is not a flux")
    arrays = cos.build_cosmo_arrays(3.0)
    for dtype in (torch.float64, torch.float32):
        table = cos.build_cosmo_table(3.0, dtype=dtype, device=dev)
        for k in cos.COSMO_FIELDS:
            got = getattr(table, k)
            want = torch.tensor(arrays[k], dtype=dtype)
            if got.device.type != dev.type or not torch.equal(got.cpu(),
                                                              want):
                fail(f"api: build_cosmo_table's {k} ({dtype}) is not "
                     "build_cosmo_arrays'")
    return errs


def phase_api(dev):
    """The "api" phase: the library functions added with the public API
    on the card against the CPU (:func:`_api_functions`), then the
    flagship ``fit`` model (``-mcf 0.5``, the fits' 2000-source catalog,
    trapz-101) through the public ``samplers.step``: ``API_STEPS`` steps
    from a seeded generator on the card, every launch counter set to 0
    just before and read just after (exactly 2 ``free_lnlike`` a step and
    no other kernel), their positions and lnp bit for bit those of
    ``run_stretch``'s loop over the same draws, one ``step`` bit for bit
    ``run_stretch(nsteps=1)``; and ``VeffLF()`` the table of
    ``veff_lf()``. Returns the steps' launches."""
    from lumfuncmcmc_tpu_torch import samplers
    from lumfuncmcmc_tpu_torch.samplers import affine
    t0 = time.perf_counter()
    errs = _api_functions(dev)
    model = _flagship_model(dev)
    lnprob = model.lnprob_batch()
    if not lnprob.engine.startswith("cuda"):
        fail(f"api: the flagship model's engine is {lnprob.engine}")
    pos0 = sample_init(torch.Generator(device=dev).manual_seed(16),
                       model.layout, NWALKERS, dtype=torch.float32,
                       device=dev)
    state = affine.EnsembleState(pos0, lnprob(pos0))
    for name in KERNELS:
        _kernel(name).launches = 0
    gen = torch.Generator(device=dev).manual_seed(17)
    steps, accepted = [], 0
    for _ in range(API_STEPS):
        state, acc = samplers.step(gen, state, lnprob)
        steps.append(state)
        accepted += int(acc.sum())
    torch.cuda.synchronize()
    counts = {name: _kernel(name).launches for name in KERNELS}
    _expect("api steps", counts, {"free_lnlike": 2 * API_STEPS})
    if not (0 < accepted and torch.isfinite(state.lnp).all()):
        fail(f"api: {accepted} moves accepted, lnp finite: "
             f"{bool(torch.isfinite(state.lnp).all())}")
    # run_stretch(nsteps=3) draws each random's three steps in one bulk
    # call, so the same seed gives three steps other randoms: the steps
    # are held to its loop (run_with_rands) over their own draws
    gen = torch.Generator(device=dev).manual_seed(17)
    draws = [affine.draw_rands(gen, "stretch", 1, pos0)
             for _ in range(API_STEPS)]
    rands = tuple(torch.cat(x) for x in zip(*draws))
    _, chain, lnps, _ = affine.run_with_rands(lnprob, pos0, rands,
                                              API_STEPS)
    for t, st in enumerate(steps):
        if not (torch.equal(st.pos, chain[t]) and torch.equal(st.lnp,
                                                               lnps[t])):
            fail(f"api: step {t + 1} differs from run_stretch's loop over "
                 "the same draws")
    one, _ = samplers.step(torch.Generator(device=dev).manual_seed(18),
                           affine.EnsembleState(pos0, lnprob(pos0)), lnprob)
    want, _, _, _ = samplers.run_stretch(
        lnprob, pos0, torch.Generator(device=dev).manual_seed(18), 1)
    if not (torch.equal(one.pos, want.pos) and torch.equal(one.lnp,
                                                           want.lnp)):
        fail("api: step differs from run_stretch(nsteps=1) on one seed")
    lavg, lf, var = model.VeffLF()
    lavg2, lf2, var2 = model.veff_lf()
    # the binning sums in the card's atomics order (index_add_,
    # scatter_add_): the table agrees to float32 sums in another order
    veff_err = max(float(np.max(np.abs(a - b) / np.maximum(
        np.abs(b), np.finfo(np.float64).tiny)))
        for a, b in ((lavg, lavg2), (lf, lf2), (var, var2)))
    if not (np.array_equal(lavg, lavg2) and veff_err <= RTOL_KERNEL
            and np.isfinite(lf).all() and len(lf) == model.cfg.nbins):
        fail(f"api: VeffLF() is not veff_lf()'s table (largest relative "
             f"difference {veff_err:.3e})")
    wall = time.perf_counter() - t0
    print(f"api: {len(errs)} library functions on the card vs the CPU, "
          f"largest relative error {max(errs.values()):.3e} "
          f"({', '.join(f'{k} {v:.1e}' for k, v in errs.items())}); "
          f"build_cosmo_table equal to build_cosmo_arrays; {API_STEPS} "
          f"samplers.step calls on the flagship model: {counts['free_lnlike']}"
          f" free_lnlike launches, {accepted} moves accepted, bit for bit "
          f"run_stretch's loop; VeffLF() = veff_lf() (largest relative "
          f"difference {veff_err:.1e}); api phase wall {wall:.2f} s")
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


LONG = "long"               # the long-run drivers' path (phase 16)
LONG_BLOCK = 500            # stretch steps of a --min-ess/checkpoint block
LONG_NUTS_BLOCK = 100       # NUTS samples of one


def _cut_npz(src, dst, nblocks):
    """The checkpoint that block ``nblocks`` of a run wrote, cut from the
    run's last one: the port's npz keeps every per-block quantity on a
    leading block axis (NUTS: ``sizes``, ``df``, ``y_run``,
    ``generator``; stretch: ``acc_blocks``) beside the concatenated
    samples."""
    with np.load(src) as ck:
        d = {k: ck[k] for k in ck.files}
    if "sizes" in d:
        rows = int(d["sizes"][:nblocks].sum())
        for k in ("samples_y", "lnps_y", "alphas"):
            d[k] = d[k][:rows]
        for k in ("sizes", "df", "y_run", "generator"):
            d[k] = d[k][:nblocks]
    else:
        rows = d["chain"].shape[0] * nblocks // len(d["acc_blocks"])
        for k in ("chain", "lnprobability"):
            d[k] = d[k][:rows]
        d["acc_blocks"] = d["acc_blocks"][:nblocks]
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    np.savez(dst, **d)


def _long_run(name, argv, workdir, has_mpl, out, base, want, run_dir=None):
    """One long-run CLI run: exit code, artifacts, the exact launch counts
    ``want`` (kernel -> launches, the rest 0; a callable of the log
    records gives them), its wall and launches printed. Returns (log
    records, posterior table, run directory)."""
    run_dir = run_dir or _run_dir(workdir, name)
    rc, counts, rec, peak, wall = _drive(argv + ["--config", _smoke_config(
        workdir, has_mpl)], run_dir)
    if rc != 0:
        fail(f"{name} returned {rc}")
    post = _artifacts(name, os.path.join(run_dir, out), base, has_mpl)
    expect = {k: 0 for k in KERNELS}
    expect.update(want(rec) if callable(want) else want)
    if counts != expect:
        fail(f"{name}: launch counts {counts}, expected {expect}")
    used = {k: v for k, v in counts.items() if v}
    print(f"{name}: CLI wall {wall:.1f} s, launches {used or 'none'}, "
          f"device memory peak {peak / 2**20:.1f} MiB")
    return rec, post, run_dir


def _long_base(nsteps, nw=NWALKERS):
    return f"test_nb50_nw{nw}_ns{nsteps}_mcf50"


def _nuts_launches(rec, name, guard=True, fam="fixed"):
    """A NUTS run's exact launches from its log (on a grid, this rank's):
    the family's value+gradient kernel once per transition and leapfrog
    step, its value kernel for the start guard (skipped on a resume) and
    the Ln Prob recompute (one launch a ``MAX_ROWS`` chunk of the whole
    chain's rows, a slice of each on every rank of a grid)."""
    ntrans, nlf = _logged(rec, r"NUTS work: (\d+) transitions, (\d+) "
                          r"leapfrog steps", name)
    at = rec.lines.index("Shape of self.samples")
    rows = int(re.match(r"\((\d+), \d+\)$", rec.lines[at + 1]).group(1))
    return {f"{fam}_lnlike_vg": int(ntrans + nlf),
            f"{fam}_lnlike": int(guard) + math.ceil(rows / cl.MAX_ROWS)}


def _nuts_gates(rec, name):
    """Phase 6's NUTS gates on one run's log."""
    _, _, accept, div_pct = _logged(
        rec, r"Total time taken: ([\d.]+) s; step size ([\d.e+-]+)(?:\.\."
        r"[\d.e+-]+ \(per replica\))?; mean accept-stat ([\d.]+); "
        r"divergent transitions ([\d.]+)%", name)
    _, rhat, _ = _logged(
        rec, r"min ESS: ([\d.]+); max R-hat: ([\d.]+); ESS/sec: ([\d.]+)",
        name)
    if not (div_pct < 5.0 and 0.6 < accept < 0.97 and rhat < 1.1):
        fail(f"{name}: divergent {div_pct}% (limit 5), accept-stat "
             f"{accept} (0.6-0.97), max R-hat {rhat} (limit 1.1)")
    return accept, div_pct, rhat


def run_long(workdir, has_mpl):
    """Phase 16, the long-run drivers on the flagship catalog (``fit
    --synthetic 2000 -mcf 0.5``, 100 walkers), each run between the
    launch counters' zero and read: a checkpointed fit resumed from its
    npz cut at 2 blocks (bit for bit), ``--min-ess`` blocks, four
    ensembles in one launch a half-step, ``fith --ensembles 2``, NUTS
    checkpointed and resumed (bit for bit) and in min-ess blocks,
    ``--exact-bounds`` on the eager engine (no launch) and ``--profile``.
    Returns the launch counts summed over the runs."""
    cat = ["--synthetic", str(NSYNTH), "-mcf", "0.5", "-nw", str(NWALKERS)]
    total = {k: 0 for k in KERNELS}
    blk = 1 + 2 * LONG_BLOCK

    def add(rec_counts):
        for k, v in rec_counts.items():
            total[k] += v

    # a checkpointed fit, then the same command on its npz cut at 2 of 4
    ck_argv = ["fit"] + cat + ["-ns", str(4 * LONG_BLOCK),
                               "--checkpoint-every", str(LONG_BLOCK)]
    base = _long_base(4 * LONG_BLOCK)
    npz = os.path.join("LFMCMCOut", f"checkpoint_{base}.npz")
    rec, post, ck_dir = _long_run("long fit --checkpoint-every", ck_argv,
                                  workdir, has_mpl, "LFMCMCOut", base,
                                  {"free_lnlike": 4 * blk})
    add({"free_lnlike": 4 * blk})
    ref_col = np.asarray(post[r"$\log L_*$"])
    (ess_2000,) = _logged(rec, r"min ESS: ([\d.]+);", "long fit")
    res_dir = _run_dir(workdir, "long fit resumed")
    _cut_npz(os.path.join(ck_dir, npz), os.path.join(res_dir, npz), 2)
    rec, _, _ = _long_run("long fit --checkpoint-every (resumed at 2 of 4 "
                          "blocks)", ck_argv, workdir, has_mpl, "LFMCMCOut",
                          base, {"free_lnlike": 2 * blk}, run_dir=res_dir)
    add({"free_lnlike": 2 * blk})
    with np.load(os.path.join(ck_dir, npz)) as a, \
            np.load(os.path.join(res_dir, npz)) as b:
        if not (np.array_equal(a["chain"], b["chain"])
                and np.array_equal(a["lnprobability"], b["lnprobability"])
                and np.array_equal(a["acc_blocks"], b["acc_blocks"])):
            fail("long fit: the resumed chain differs from the "
                 "uninterrupted checkpointed run's")
        chain = a["chain"]
    print(f"long fit: the run resumed at 2 of 4 blocks equals the "
          f"uninterrupted one bit for bit (chain, lnprobability, acceptance"
          f"); one-run min ESS {ess_2000:.0f}")

    # --min-ess: its block b draws as the checkpointed run's block b, so
    # a target between that chain's one-block and two-block min ESS (the
    # rule of fit_model_until) runs two blocks
    e1, e2 = (_EnsembleDriverMixin._min_ess(chain[:n * LONG_BLOCK])[0]
              for n in (1, 2))
    target = 0.5 * (e1 + e2) if e1 < e2 else 1.2 * e1
    name = f"long fit --min-ess {target:.0f}"

    def ess_launches(rec):
        return {"free_lnlike": blk * len(
            [ln for ln in rec.lines if ln.startswith("Block ")])}
    rec, _, ess_dir = _long_run(
        name, ["fit"] + cat + ["-ns", str(LONG_BLOCK), "--min-ess",
                               str(target), "--checkpoint-every",
                               str(LONG_BLOCK)],
        workdir, has_mpl, "LFMCMCOut", _long_base(LONG_BLOCK), ess_launches)
    blocks = [ln for ln in rec.lines if ln.startswith("Block ")]
    (last,) = _logged(rec, r"min ESS=([\d.]+) \(target", name)
    if len(blocks) < 2 or not (last >= target - 0.5 or len(blocks) == 50):
        fail(f"{name}: {len(blocks)} blocks, last min ESS {last}")
    add(ess_launches(rec))
    n = min(len(blocks), 4) * LONG_BLOCK
    with np.load(os.path.join(ess_dir, "LFMCMCOut", "checkpoint_until_"
                              f"{_long_base(LONG_BLOCK)}.npz")) as c:
        if not np.array_equal(c["chain"][:n], chain[:n]):
            fail(f"{name}: its blocks differ from the checkpointed run's")
    (secs,) = _logged(rec, r"Total time taken: ([\d.]+) s \(", name)
    print(f"{name}: {len(blocks)} blocks of {LONG_BLOCK} steps (one "
          f"block's min ESS {e1:.0f}, two blocks' {e2:.0f}), last min ESS "
          f"{last:.0f}, sampling {secs:.3f} s; its chain is the "
          "checkpointed run's, block for block")

    # four ensembles, one launch a half-step for all of them
    name = "long fit --ensembles 4"
    rec, post, _ = _long_run(name, ["fit"] + cat + ["-ns", str(NSTEPS),
                                                    "--ensembles", "4"],
                             workdir, has_mpl, "LFMCMCOut",
                             _long_base(NSTEPS), {"free_lnlike": 1 + 2 * NSTEPS})
    add({"free_lnlike": 1 + 2 * NSTEPS})
    _, rhat_ens, _ = _logged(rec, r"min ESS: ([\d.]+); max cross-ensemble "
                             r"R-hat: ([\d.]+) \((\d+) ensembles\)", name)
    rows = select_samples(np.column_stack([post[k] for k in post]))
    col = rows[:, list(post).index(r"$\log L_*$")]
    gap = abs(np.median(col) - np.median(ref_col)) / np.std(col)
    if not (rhat_ens < 1.1 and gap < 3.0):
        fail(f"{name}: cross-ensemble R-hat {rhat_ens} (limit 1.1), logL* "
             f"median {np.median(col):.4f} {gap:.2f} sd from the fit's "
             f"{np.median(ref_col):.4f} (limit 3)")
    (secs,) = _logged(rec, r"Total time taken: ([\d.]+) s$", name)
    print(f"{name}: 2 x {NSTEPS} + 1 launches at W = {4 * NWALKERS // 2} "
          f"rows a half-step, cross-ensemble R-hat {rhat_ens:.4f}, logL* "
          f"median {np.median(col):.4f} ({gap:.2f} sd from the fit's), "
          f"sampling {secs:.3f} s")

    # the hierarchical model's two ensembles
    nh = NSTEPS // 2
    name = "long fith --ensembles 2"
    rec, _, _ = _long_run(name, ["fith"] + cat + ["-ns", str(nh),
                                                  "--ensembles", "2"],
                          workdir, has_mpl, "LFMCMCHOut", _long_base(nh),
                          {"hier_lnlike": 1 + 2 * nh})
    add({"hier_lnlike": 1 + 2 * nh})
    (secs,) = _logged(rec, r"Total time taken: ([\d.]+) s$", name)
    print(f"{name}: sampling {secs:.3f} s")

    # NUTS checkpointed in blocks, then resumed from the npz cut at 1 of 2
    nuts = ["fit", "-fc", "--sampler", "nuts", "--synthetic", str(NSYNTH),
            "-mcf", "0.5", "--nchains", str(NUTS_CHAINS)]
    ck_argv = nuts + ["-ns", str(2 * LONG_NUTS_BLOCK), "--checkpoint-every",
                      str(LONG_NUTS_BLOCK)]
    base = _long_base(2 * LONG_NUTS_BLOCK)
    npz = os.path.join("LFMCMCOut", f"checkpoint_nuts_{base}.npz")
    name = "long fit -fc --sampler nuts --checkpoint-every"
    rec, post, ck_dir = _long_run(
        name, ck_argv, workdir, has_mpl, "LFMCMCOut", base,
        lambda r: _nuts_launches(r, name))
    add(_nuts_launches(rec, name))
    accept, div_pct, rhat = _nuts_gates(rec, name)
    res_dir = _run_dir(workdir, "long nuts resumed")
    _cut_npz(os.path.join(ck_dir, npz), os.path.join(res_dir, npz), 1)
    rname = name + " (resumed at 1 of 2 blocks)"
    rec2, _, _ = _long_run(rname, ck_argv, workdir, has_mpl, "LFMCMCOut",
                           base, lambda r: _nuts_launches(r, rname, False),
                           run_dir=res_dir)
    add(_nuts_launches(rec2, rname, False))
    with np.load(os.path.join(ck_dir, npz)) as a, \
            np.load(os.path.join(res_dir, npz)) as b:
        if not all(np.array_equal(a[k], b[k]) for k in
                   ("samples_y", "lnps_y", "alphas", "y_run", "generator")):
            fail(f"{name}: the resumed chain differs from the "
                 "uninterrupted checkpointed run's")
    print(f"{name}: accept-stat {accept:.2f}, divergent {div_pct:.2f}%, max "
          f"R-hat {rhat:.4f}; the run resumed at 1 of 2 blocks equals it "
          "bit for bit (samples, lnp, accept-stats, states, generator)")

    # NUTS min-ess: a target between the first block's ESS and the two
    # blocks' (the min-ess chain is the checkpointed run's, block for
    # block), so that two blocks run
    names = [k for k in post if k != "Ln Prob"]
    x = np.column_stack([post[k] for k in names]).reshape(
        2 * LONG_NUTS_BLOCK, NUTS_CHAINS, len(names))
    e1 = float(effective_sample_size(x[:LONG_NUTS_BLOCK]).min())
    e2 = float(effective_sample_size(x).min())
    target = 0.5 * (e1 + e2) if e1 < e2 else 1.2 * e1
    name = f"long fit -fc --sampler nuts --min-ess {target:.0f}"
    rec, _, _ = _long_run(name, nuts + ["-ns", str(LONG_NUTS_BLOCK),
                                        "--min-ess", str(target)],
                          workdir, has_mpl, "LFMCMCOut",
                          _long_base(LONG_NUTS_BLOCK),
                          lambda r: _nuts_launches(r, name))
    add(_nuts_launches(rec, name))
    nblocks = len([ln for ln in rec.lines if ln.startswith("NUTS block ")])
    accept, div_pct, rhat = _nuts_gates(rec, name)
    if nblocks < 2:
        fail(f"{name}: {nblocks} blocks (one block's ESS {e1:.0f}, two "
             f"blocks' {e2:.0f})")
    (secs,) = _logged(rec, r"Total time taken: ([\d.]+) s;", name)
    print(f"{name}: {nblocks} blocks of {LONG_NUTS_BLOCK} samples (one "
          f"block's ESS {e1:.0f}, two blocks' {e2:.0f}), accept-stat "
          f"{accept:.2f}, divergent {div_pct:.2f}%, max R-hat {rhat:.4f}, "
          f"sampling {secs:.2f} s")

    # exact bounds: the eager engine on the card, no kernel launch
    name = "long fit --exact-bounds"
    rec, post, _ = _long_run(name, ["fit"] + cat + ["-ns", str(NSTEPS),
                                                    "--exact-bounds"],
                             workdir, has_mpl, "LFMCMCOut",
                             _long_base(NSTEPS), {})
    if not any("(engine: eager, device: cuda" in ln for ln in rec.lines):
        fail(f"{name}: the log does not name the eager engine")
    rows = select_samples(np.column_stack([post[k] for k in post]))
    col = rows[:, list(post).index(r"$\log L_*$")]
    gap = abs(np.median(col) - np.median(ref_col)) / np.std(ref_col)
    if not gap < 3.0:
        fail(f"{name}: logL* median {np.median(col):.4f} is {gap:.2f} sd "
             f"from the frozen-bounds fit's {np.median(ref_col):.4f}")
    (secs,) = _logged(rec, r"Total time taken: ([\d.]+) s$", name)
    print(f"{name}: eager engine, no launch, logL* median "
          f"{np.median(col):.4f} ({gap:.2f} sd from the frozen-bounds "
          f"fit's), sampling {secs:.3f} s")

    # --profile: a torch.profiler trace naming the free value kernel
    name, nprof = "long fit --profile", 50
    prof = os.path.join(workdir, "long_profile")
    _long_run(name, ["fit"] + cat + ["-ns", str(nprof), "--profile", prof],
              workdir, has_mpl, "LFMCMCOut", _long_base(nprof),
              {"free_lnlike": 1 + 2 * nprof})
    add({"free_lnlike": 1 + 2 * nprof})
    traces = [os.path.join(prof, f) for f in os.listdir(prof)]
    if not any("free_vg" in open(f).read() for f in traces):
        fail(f"{name}: no trace under {prof} names free_vg ({traces})")
    print(f"{name}: {len(traces)} trace file(s), "
          f"{sum(os.path.getsize(f) for f in traces) / 2**20:.1f} MiB, "
          "naming free_vg")
    return total


GRID = "grid"               # the device grid's path (phase 17)
GRID_STEPS = 1000           # stretch steps of the grid's flagship fits
GRID_MEGA_STEPS = 500       # of its mega fit
GRID_SECONDS = 600          # what its two rank processes may take
GRID_DEVICE = "cuda:0"      # both ranks' card
GRID_NUTS_CHAINS = 8        # chains of the grid's NUTS runs (at least)
GRID_NUTS_WARMUP, GRID_NUTS_STEPS = 100, 120    # on the flagship catalog
GRID_MEGA_NUTS = (40, 40)   # warmup and samples on the mega catalog
GRID_NUTS_CK = "grid_nuts_ck.npz"   # the mega replica run's checkpoint


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grid_argv(workdir, has_mpl, cmd="fit", extra=()):
    """The flagship stretch fit's command line at ``GRID_STEPS``."""
    return [cmd, "--synthetic", str(NSYNTH), "-mcf", "0.5", "-nw",
            str(NWALKERS), "-ns", str(GRID_STEPS), "--config",
            _smoke_config(workdir, has_mpl)] + list(extra)


def _grid_base():
    return f"test_nb50_nw{NWALKERS}_ns{GRID_STEPS}_mcf50"


def _flagship_model(dev, **over):
    """The flagship ``fit`` model through the library API, on the CLI's
    catalog (``_load_inputs``), in the card's default dtype."""
    from lumfuncmcmc_tpu_torch.cli.common import _align_fields, _load_inputs
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
    cfg = LFConfig(min_comp_frac=0.5, nwalkers=NWALKERS, **over)
    inputs = _load_inputs(SimpleNamespace(synthetic=NSYNTH, filename=None),
                          cfg)
    cfg = _align_fields(cfg, inputs.pop("field_names"))
    return LumFuncModel(cfg, **inputs, device=dev, dtype=torch.float32)


def _grid_mega_model(dev, **over):
    """The mega catalog's ``fit`` model (``use_x64``, gauss-32, seed 7)
    through the library API at ``GRID_MEGA_STEPS``, and its catalog."""
    from lumfuncmcmc_tpu_torch.models.model import LumFuncModel
    cfg = LFConfig(**{**dict(min_comp_frac=0.5, quadrature="gauss",
                             seed=MEGA_SEED, nwalkers=NWALKERS,
                             nsteps=GRID_MEGA_STEPS, use_x64=True), **over})
    cat = apply_completeness_cut(
        make_catalog(cfg, n_target=MEGA_TARGET, seed=MEGA_SEED), cfg)
    return LumFuncModel(cfg, z=cat["z"], flux=cat["flux"],
                        flux_e=cat["flux_e"], field_id=cat["field_id"],
                        device=dev, dtype=torch.float64), cat


def _expect(label, counts, want):
    full = {k: 0 for k in KERNELS}
    full.update(want)
    if counts != full:
        fail(f"{label}: launch counts {counts}, expected {full}")


def _rows_of(name):
    """Record the walker rows of every ``name`` launch (the one-launch
    kernels' ``_launch_vg``); returns the list and the undo."""
    rows, launch = [], cl._launch_vg

    def recorded(kname, feats, *a, **kw):
        if kname == name:
            rows.append(int(feats.shape[0]))
        return launch(kname, feats, *a, **kw)
    cl._launch_vg = recorded

    def undo():
        cl._launch_vg = launch
    return rows, undo


def _grid_nuts(label, model, fam, kw, ref_median, say=print, guard=True):
    """One NUTS run of ``model`` (``fit_model_nuts(**kw)``), every launch
    counter set to 0 just before and read just after: its launches exact
    (:func:`_nuts_launches`: on a grid, this rank's), phase 6's gates,
    and the posterior's logL* median within 3 of its sd of the stretch
    fit's ``ref_median``. Prints its line; returns (launches, log records,
    the logged step size)."""
    rec = _Records()
    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    log.addHandler(rec)
    try:
        for name in KERNELS:
            _kernel(name).launches = 0
        samples = model.fit_model_nuts(**kw)
        counts = {name: _kernel(name).launches for name in KERNELS}
    finally:
        log.removeHandler(rec)
    _expect(label, counts, _nuts_launches(rec, label, guard, fam))
    accept, div_pct, rhat = _nuts_gates(rec, label)
    (secs,) = _logged(rec, r"Total time taken: ([\d.]+) s;", label)
    step = re.search(r"step size ([^;]+);", next(
        ln for ln in reversed(rec.lines)
        if ln.startswith("Total time taken"))).group(1)
    ntrans, nlf = _logged(rec, r"NUTS work: (\d+) transitions, (\d+) "
                          r"leapfrog steps", label)
    col = samples[:, 0]
    gap = abs(np.median(col) - ref_median) / np.std(col)
    if not gap < 3.0:
        fail(f"{label}: logL* median {np.median(col):.4f} is {gap:.2f} "
             f"posterior sd from the stretch fit's {ref_median:.4f}")
    vg = f"{fam}_lnlike_vg"
    say(f"{label}: {int(ntrans)} transitions + {int(nlf)} leapfrog steps = "
        f"{vg} launches {counts[vg]}, {fam}_lnlike {counts[f'{fam}_lnlike']}"
        f"; sampling {secs:.2f} s, {secs / (ntrans + nlf) * 1e3:.3f} ms per "
        f"value+gradient call; step size {step}; accept-stat {accept}, "
        f"divergent {div_pct}%, max R-hat {rhat}; logL* median "
        f"{np.median(col):.4f} vs the stretch fit's {ref_median:.4f} "
        f"({gap:.2f} sd)")
    return counts, rec, step


def run_grid(workdir, has_mpl):
    """Phase 17, the device grid. In this process, a world of 1 under
    NCCL: ``fit --mesh-walkers 1 --distributed 127.0.0.1:PORT,1,0``
    beside the plain ``fit`` (the meshless path: the same launches, 2 x
    steps + 1 ``free_lnlike``, and the same fitposterior bytes), then
    the plain ``fit``'s evidence ladder (16 rungs, ``LADDER_STEPS``) and
    the stretch fits the grid's NUTS runs are held to (``fit -fc``, the
    meshless mega ``fit_model``). Then two ranks on the one card
    (:func:`grid_rank`, each a process that joins a gloo group through
    ``init_distributed``; NCCL refuses two ranks on one device), whose
    launch counts are added to the paths', and last the ranks' mega
    replica checkpoint resumed here (:func:`_grid_nuts_resume`)."""
    dev = torch.device(GRID_DEVICE)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    t0 = time.perf_counter()
    argv = _grid_argv(workdir, has_mpl)
    want = {"free_lnlike": 2 * GRID_STEPS + 1}
    runs = []
    post = []
    for name, extra in (("plain", []), ("world 1", [
            "--mesh-walkers", "1", "--distributed",
            f"127.0.0.1:{_free_port()},1,0"])):
        run_dir = os.path.join(workdir, f"grid_{name.replace(' ', '')}")
        rc, counts, rec, peak, wall = _drive(argv + extra, run_dir)
        if rc != 0:
            fail(f"grid {name} fit returned {rc}")
        _expect(f"grid {name} fit", counts, want)
        if extra and not any(ln == f"Process group: rank 0 of 1 ({backend})"
                             for ln in rec.lines):
            fail(f"grid world 1: the fit did not join a {backend} group of "
                 "one")
        out = os.path.join(run_dir, "LFMCMCOut")
        _artifacts(f"grid {name} fit", out, _grid_base(), has_mpl)
        with open(os.path.join(out, f"fitposterior_{_grid_base()}.dat"),
                  "rb") as fh:
            post.append(fh.read())
        runs.append(counts)
        print(f"grid {name} fit: CLI wall {wall:.1f} s, sampling loop "
              f"{rec.value('Total time taken:'):.3f} s, free_lnlike "
              f"launches {counts['free_lnlike']}")
    if post[0] != post[1]:
        fail("grid world 1: the fitposterior differs from the plain fit's")
    print(f"grid world 1 ({backend}, --distributed 127.0.0.1:PORT,1,0, "
          "--mesh-walkers 1): the meshless path, its fitposterior the plain "
          "fit's byte for byte")
    _check_no_jax()
    model = _flagship_model(dev)
    t1 = time.perf_counter()
    ev = model.log_evidence(nrungs=EVIDENCE_RUNGS, nsteps=LADDER_STEPS)
    ladder_s = time.perf_counter() - t1
    names = list(read_fixed_width_two_line(os.path.join(
        workdir, "grid_plain", "LFMCMCOut",
        f"fitposterior_{_grid_base()}.dat")))
    ref = {"lnz": ev["lnz_ss"], "ladder_s": ladder_s, "col": names[0],
           "post": os.path.join(workdir, "grid_plain", "LFMCMCOut",
                                f"fitposterior_{_grid_base()}.dat")}
    ref["med_free"] = float(np.median(read_fixed_width_two_line(
        ref["post"])[names[0]]))
    del model
    # the stretch fit the grid's `fit -fc --sampler nuts` is held to
    model = _flagship_model(dev, fix_comp=True, nsteps=GRID_STEPS)
    for name in KERNELS:
        _kernel(name).launches = 0
    model.fit_model()
    counts = {name: _kernel(name).launches for name in KERNELS}
    _expect("grid plain fit -fc", counts,
            {"fixed_lnlike": 2 * GRID_STEPS + 1})
    runs.append(counts)
    ref["med_fixed"] = float(np.median(model.samples[:, 0]))
    del model
    torch.cuda.empty_cache()
    model, cat = _grid_mega_model(dev, mesh_sources=1)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    model.fit_model()
    ref["mega_s"] = time.perf_counter() - t1
    ref["mega_peak"] = torch.cuda.max_memory_allocated()
    ref["med_mega"] = float(np.median(model.samples[:, 0]))
    print(f"grid: the meshless mega fit_model ({GRID_MEGA_STEPS} steps, "
          f"{int(model.ctx.lum.shape[0])} sources): sampling "
          f"{ref['mega_s']:.2f} s, device memory peak "
          f"{ref['mega_peak'] / 2**20:.1f} MiB")
    with open(os.path.join(workdir, "grid_ref.json"), "w") as fh:
        json.dump(ref, fh)
    del model, cat
    torch.cuda.empty_cache()
    port = _free_port()
    procs = []
    try:
        for r in range(2):
            out = open(os.path.join(workdir, f"grid_rank{r}.out"), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--grid-rank",
                 str(r), str(port), workdir, str(int(has_mpl))],
                stdout=out), out))
        deadline = time.monotonic() + GRID_SECONDS
        for r, (proc, out) in enumerate(procs):
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            out.seek(0)
            lines = out.read().splitlines()
            print("\n".join(lines[:-1]))
            if rc != 0:
                fail(f"grid rank {r} returned {rc}")
            got = json.loads(lines[-1])
            if got["grid_rank"] != r:
                fail(f"grid rank {r}: the process reported {got}")
            runs.append(got["launches"])
    finally:
        for proc, out in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    runs.append(_grid_nuts_resume(workdir, dev, ref))
    print(f"grid: phase 17 wall {time.perf_counter() - t0:.1f} s")
    return {k: sum(r[k] for r in runs) for k in KERNELS}


def _grid_nuts_resume(workdir, dev, ref):
    """The mega replica run's checkpoint (written by rank 0 of the (2,1)
    grid, two blocks) cut at its first block and resumed on a world of 1:
    the second block's launches exact (no start guard), phase 6's gates,
    and the samples, Ln Prob, acceptance statistics and per-chain state of
    the npz it writes those of the grid's, bit for bit (the streaming
    kernels sum a chain's terms in one order whatever the batch's width)."""
    ck = os.path.join(workdir, GRID_NUTS_CK)
    cut = os.path.join(workdir, "grid_world1", GRID_NUTS_CK)
    _cut_npz(ck, cut, 1)
    model, _ = _grid_mega_model(dev, nsteps=GRID_MEGA_NUTS[1],
                                checkpoint_every=GRID_MEGA_NUTS[1] // 2)
    if model.grid is not None:
        fail("grid world 1 NUTS resume: the model is on a grid")
    label = "grid world 1: the mega (2,1) replica checkpoint resumed"
    counts, rec, _ = _grid_nuts(
        label, model, "free_stream", dict(
            num_warmup=GRID_MEGA_NUTS[0], nchains=GRID_NUTS_CHAINS,
            checkpoint_path=cut, resume=True),
        ref["med_mega"], guard=False)
    if not any("start guard skipped" in ln for ln in rec.lines):
        fail(f"{label}: it did not resume")
    with np.load(ck) as a, np.load(cut) as b:
        same = [k for k in ("samples_y", "lnps_y", "alphas", "y_run",
                            "eps", "scale") if np.array_equal(a[k], b[k])]
        if len(same) != 6:
            fail(f"{label}: only {same} equal the grid's bit for bit "
                 f"(largest sample difference "
                 f"{np.abs(a['samples_y'] - b['samples_y']).max():.3e})")
    print(f"{label}: the second block's samples, Ln Prob, acceptance and "
          "per-chain state the grid's bit for bit")
    del model
    torch.cuda.empty_cache()
    return counts


def _collective_clock():
    """Host seconds and calls inside the grid's collectives (the sharded
    lnprob's ``all_gather_rows``/``all_reduce_sum``, each ending in the
    copy back, so a wait for the device's value is in it): ``[seconds,
    calls]``, and the undo."""
    from lumfuncmcmc_tpu_torch.parallel import sharding as sh
    tot, saved = [0.0, 0], (sh.all_gather_rows, sh.all_reduce_sum)

    def clocked(fn):
        def inner(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            tot[0] += time.perf_counter() - t
            tot[1] += 1
            return out
        return inner
    sh.all_gather_rows, sh.all_reduce_sum = (clocked(f) for f in saved)

    def undo():
        sh.all_gather_rows, sh.all_reduce_sum = saved
    return tot, undo


def _rank_print(rank, msg):
    print(f"grid rank {rank}: {msg}", flush=True)


def grid_rank(rank, port, workdir, has_mpl):
    """One of phase 17's two ranks on the one card: a gloo group of two
    (``init_distributed(..., backend="gloo")``; gloo takes the collectives'
    CUDA tensors staged through the host), then, each run with every launch
    counter set to 0 just before and read just after, its counts exact
    per rank:

    - ``fit --mesh-walkers 2`` (the (2,1) grid; the value kernels
      walker-split): 2 x steps + 1 ``free_lnlike`` launches a rank, each
      of W/4 = 25 rows (the start W/2); the posterior's logL* median
      within 3 sd of the plain fit's; the grid's lnprob of 32 thetas
      against the meshless kernel lnprob within ``RTOL_KERNEL``;
    - the mega catalog on (1,2) through the library (``fit_model``,
      ``use_x64``): the streaming kernels on source shards, 2 x steps + 1
      ``free_stream_lnlike`` a rank and no ``free_lnlike``; the lnp
      differences of 32 close pairs through the sharded lnprob against the
      float64 eager engine within ``DLNP_TOL``; each rank's device memory
      peak;
    - ``fith --ensembles 2 --mesh-walkers 2``: one ensemble a rank, 2 x
      steps + 1 ``hier_lnlike``;
    - ``log_evidence(16 rungs)`` on (2,1): 8 rungs a rank, 1 + 2 x steps +
      the recompute's chunks ``free_lnlike``; |dlnZ| against the meshless
      ladder (:func:`run_grid`) within ``DLNP_TOL``;
    - NUTS (:func:`_grid_nuts`, ``fit_model_nuts``): the mega catalog's
      sharded streaming value+gradient against the meshless one, its
      streaming route on (1,2) and its replicas on (2,1) (checkpointed;
      both from ``--init-map`` starts: from the box, the 1e6-source
      posterior's warmup is long), the flagship's replicas adapting alone
      and pooled, and ``fit -fc`` on the pooled route.

    Prints its lines, then one JSON line with its launch counts."""
    from lumfuncmcmc_tpu_torch.parallel.distributed import (
        init_distributed, shutdown)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                     timeout=GRID_SECONDS)
    dev = torch.device(GRID_DEVICE)
    with open(os.path.join(workdir, "grid_ref.json")) as fh:
        ref = json.load(fh)
    runs = []
    say = functools.partial(_rank_print, rank)
    say("gloo group of 2 on one card (collectives' CUDA tensors staged "
        "through the host)")

    # the flagship fit on (2,1)
    rows, undo = _rows_of("free_lnlike")
    coll, undo_coll = _collective_clock()
    try:
        run_dir = os.path.join(workdir, f"grid_fit_rank{rank}")
        rc, counts, rec, peak, wall = _drive(
            _grid_argv(workdir, has_mpl, extra=["--mesh-walkers", "2"]),
            run_dir)
    finally:
        undo()
        undo_coll()
    if rc != 0:
        fail(f"grid rank {rank} fit returned {rc}")
    _expect(f"grid rank {rank} fit (2,1)", counts,
            {"free_lnlike": 2 * GRID_STEPS + 1})
    if rows != [NWALKERS // 2] + [NWALKERS // 4] * (2 * GRID_STEPS):
        fail(f"grid rank {rank} fit: launch rows {sorted(set(rows))}, "
             f"expected {NWALKERS // 2} then {NWALKERS // 4}")
    runs.append(counts)
    loop_s = rec.value("Total time taken:")
    line = (f"fit (2,1): CLI wall {wall:.1f} s, sampling loop {loop_s:.3f} "
            f"s, {loop_s / GRID_STEPS * 1e3:.3f} ms a step, of which the "
            f"all_gather {coll[0] / GRID_STEPS * 1e3:.3f} ms ({coll[1]} calls,"
            f" {100 * coll[0] / loop_s:.1f}% of the loop, host clock, device "
            f"sync included), free_lnlike launches {counts['free_lnlike']} of "
            f"{NWALKERS // 4} rows, device memory peak {peak / 2**20:.1f} MiB")
    if rank == 0:
        mine = read_fixed_width_two_line(os.path.join(
            run_dir, "LFMCMCOut", f"fitposterior_{_grid_base()}.dat"))
        plain = read_fixed_width_two_line(ref["post"])
        col = ref["col"]
        m0, sd0 = np.median(plain[col]), np.std(plain[col])
        m1 = np.median(mine[col])
        if not abs(m1 - m0) < 3 * sd0:
            fail(f"grid fit (2,1): logL* median {m1:.4f}, plain {m0:.4f} "
                 f"(sd {sd0:.4f})")
        same = np.array_equal(np.asarray(mine[col]), np.asarray(plain[col]))
        line += (f"; logL* median {m1:.4f} vs the plain fit's {m0:.4f} (sd "
                 f"{sd0:.4f}), chains {'identical' if same else 'differ'}")
    elif os.path.exists(os.path.join(run_dir, "LFMCMCOut")):
        fail("grid rank 1 wrote artifacts")
    say(line)
    model = _flagship_model(dev, mesh_walkers=2)
    th = _central_thetas(model.cfg, model.layout, 32,
                         torch.Generator(device=dev).manual_seed(17), dev)
    th = th.to(model.dtype)
    got = model.lnprob_batch()(th)
    want_l = cl.make_cuda_lnprob(model.ctx, model.layout)(th)
    err = _rel(got.double(), want_l.double())
    if not err <= RTOL_KERNEL:
        fail(f"grid rank {rank}: lnprob on the grid vs meshless max rel "
             f"{err:.3e}")
    say(f"lnprob of 32 thetas on the (2,1) grid vs meshless: max rel "
        f"{err:.3e} (limit {RTOL_KERNEL:g})")

    # the evidence ladder on (2,1)
    for name in KERNELS:
        _kernel(name).launches = 0
    t0 = time.perf_counter()
    ev = model.log_evidence(nrungs=EVIDENCE_RUNGS, nsteps=LADDER_STEPS)
    ladder_s = time.perf_counter() - t0
    counts = {name: _kernel(name).launches for name in KERNELS}
    per = EVIDENCE_RUNGS // 2
    _expect(f"grid rank {rank} ladder", counts, {
        "free_lnlike": 1 + 2 * LADDER_STEPS
        + -(-per * LADDER_STEPS * NWALKERS // cl.MAX_ROWS)})
    runs.append(counts)
    d = abs(ev["lnz_ss"] - ref["lnz"])
    if not d <= DLNP_TOL:
        fail(f"grid rank {rank} ladder: ln Z {ev['lnz_ss']:.4f} vs meshless "
             f"{ref['lnz']:.4f}")
    say(f"evidence ladder ({EVIDENCE_RUNGS} rungs, {per} a rank, "
        f"{LADDER_STEPS} steps): ln Z {ev['lnz_ss']:.4f} vs the meshless "
        f"ladder's {ref['lnz']:.4f} (|dlnZ| {d:.2e}); ladder wall "
        f"{ladder_s:.2f} s (meshless {ref['ladder_s']:.2f} s), "
        f"free_lnlike launches {counts['free_lnlike']}")
    del model
    _check_no_jax()

    # fith --ensembles 2 on (2,1)
    run_dir = os.path.join(workdir, f"grid_fith_rank{rank}")
    rc, counts, rec, peak, wall = _drive(_grid_argv(
        workdir, has_mpl, "fith", ["--ensembles", "2", "--mesh-walkers",
                                   "2"]), run_dir)
    if rc != 0:
        fail(f"grid rank {rank} fith --ensembles 2 returned {rc}")
    _expect(f"grid rank {rank} fith --ensembles 2", counts,
            {"hier_lnlike": 2 * GRID_STEPS + 1})
    if not any("sharded over 2 ranks" in ln for ln in rec.lines):
        fail(f"grid rank {rank} fith: the ensembles were not sharded")
    runs.append(counts)
    say(f"fith --ensembles 2 (2,1): one ensemble a rank, CLI wall "
        f"{wall:.1f} s, sampling {rec.value('Total time taken:'):.3f} s, "
        f"hier_lnlike launches {counts['hier_lnlike']}, cross-ensemble "
        f"R-hat line: "
        + next((ln for ln in rec.lines if "cross-ensemble R-hat" in ln), ""))

    # the mega catalog on (1,2): source shards
    rec = _Records()
    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    log.addHandler(rec)
    try:
        model, cat = _grid_mega_model(dev, mesh_sources=2)
        cfg = model.cfg
        torch.cuda.reset_peak_memory_stats()
        fn = model.lnprob_batch()
        for name in KERNELS:
            _kernel(name).launches = 0
        t0 = time.perf_counter()
        model.fit_model()
        wall = time.perf_counter() - t0
        counts = {name: _kernel(name).launches for name in KERNELS}
    finally:
        log.removeHandler(rec)
    peak = torch.cuda.max_memory_allocated()
    _expect(f"grid rank {rank} mega (1,2)", counts,
            {"free_stream_lnlike": 2 * GRID_MEGA_STEPS + 1})
    route = "cuda-stream" if dev.type == "cuda" else "plain-stream"
    if fn.engine != route or not any(
            "sources round-robin sharded over 2 ranks" in ln
            for ln in rec.lines):
        fail(f"grid rank {rank} mega: engine {fn.engine}, or the log does "
             "not name the sharded streaming route")
    runs.append(counts)
    nsrc = int(model.ctx.lum.shape[0])
    held = int((fn.data.s_mask > 0).sum())
    tt = cat["theta_true"]
    truth = torch.tensor([tt["Lstar"], tt["phistar"], tt["sch_al"],
                          *cfg.Flim, cfg.alpha], dtype=torch.float64,
                         device=dev)
    lo, hi = model.layout.bounds_arrays(torch.float64, dev)
    th = _close_pairs(truth, hi - lo,
                      torch.Generator(device=dev).manual_seed(5))
    v = fn(th)
    line = (f"mega (1,2) through fit_model ({GRID_MEGA_STEPS} steps): "
            f"{nsrc} sources, {held} on this rank's shard, sampling "
            f"{wall:.2f} s (meshless {ref['mega_s']:.2f} s), "
            f"free_stream_lnlike launches {counts['free_stream_lnlike']}, "
            f"device memory peak {peak / 2**20:.1f} MiB (the meshless "
            f"fit_model's {ref['mega_peak'] / 2**20:.1f} MiB; PR 12's CLI "
            "mega fit, post-processing included, 6332.7 MiB)")
    if rank == 0:
        want_v = _in_rows(make_lnprob(model.ctx, model.layout), th, 8)
        err = _dlnp_err(v, want_v)
        if not err <= DLNP_TOL:
            fail(f"grid mega (1,2): lnp differences of 32 close pairs vs "
                 f"float64 eager off by {err:.4e}")
        line += (f"; lnp differences of 32 close pairs through the sharded "
                 f"lnprob vs float64 eager: max error {err:.4e} (limit "
                 f"{DLNP_TOL})")
    say(line)

    # the mega catalog's NUTS on (1,2): the streaming route
    from lumfuncmcmc_tpu_torch.parallel import sharding as sh
    from lumfuncmcmc_tpu_torch.samplers.nuts import value_and_grad
    th8 = th[:GRID_NUTS_CHAINS]
    v, g = sh.make_cuda_vg_stream_sharded(model.ctx, model.layout,
                                          model.grid, data=fn.data)(th8)
    v1, g1 = value_and_grad(cl.make_cuda_lnprob_and_grad(
        model.ctx, model.layout))(th8)
    err_v, err_g = _rel(v, v1), _grad_rel(g, g1)
    if not (err_v <= RTOL_KERNEL and err_g <= RTOL_GRAD):
        fail(f"grid rank {rank} mega (1,2): the sharded streaming "
             f"value+gradient vs meshless: value {err_v:.3e} (limit "
             f"{RTOL_KERNEL:g}), gradient {err_g:.3e} ({RTOL_GRAD:g})")
    say(f"mega (1,2): the source-sharded streaming value+gradient of "
        f"{GRID_NUTS_CHAINS} thetas vs the meshless streaming one: value max "
        f"rel {err_v:.3e} (limit {RTOL_KERNEL:g}), gradient {err_g:.3e} "
        f"(_grad_close, limit {RTOL_GRAD:g})")
    del v1, g1
    # the chains start from Laplace draws around the MAP (--init-map):
    # from the box, the 1e6-source posterior's warmup is long
    model.cfg = model.cfg.replace(nsteps=GRID_MEGA_NUTS[1], init_map=True)
    label = f"grid rank {rank} mega --sampler nuts (1,2)"
    coll, undo_coll = _collective_clock()
    try:
        counts, rec, _ = _grid_nuts(label, model, "free_stream", dict(
            num_warmup=GRID_MEGA_NUTS[0], nchains=GRID_NUTS_CHAINS),
            ref["med_mega"], say)
    finally:
        undo_coll()
    if not any("source-sharded streaming" in ln for ln in rec.lines):
        fail(f"{label}: the log does not name the streaming route")
    (secs,) = _logged(rec, r"Total time taken: ([\d.]+) s;", label)
    say(f"mega --sampler nuts (1,2): the collectives (the source group's "
        f"all_reduce of every value+gradient call, host-staged) "
        f"{coll[0]:.2f} s of the run's {secs:.2f} s sampling, "
        f"{coll[0] / max(coll[1], 1) * 1e3:.3f} ms a call over {coll[1]} "
        "calls (host clock, device sync included)")
    runs.append(counts)
    map_fit = model.map_fit
    del model, fn
    torch.cuda.empty_cache()

    # the mega catalog's per-rank replicas on (2,1), each rank adapting
    # alone, checkpointed: run_grid resumes it on a world of 1 (the same
    # catalog's MAP starts)
    model, _ = _grid_mega_model(dev, mesh_walkers=2,
                                nsteps=GRID_MEGA_NUTS[1],
                                checkpoint_every=GRID_MEGA_NUTS[1] // 2,
                                init_map=True)
    model.map_fit = map_fit
    label = f"grid rank {rank} mega --sampler nuts --checkpoint-every " \
            f"{GRID_MEGA_NUTS[1] // 2} (2,1)"
    counts, rec, _ = _grid_nuts(label, model, "free_stream", dict(
        num_warmup=GRID_MEGA_NUTS[0], nchains=GRID_NUTS_CHAINS,
        checkpoint_path=os.path.join(workdir, GRID_NUTS_CK)),
        ref["med_mega"], say)
    if not any("per-rank replicas over the 2-rank grid" in ln
               and "independent per-rank adaptation" in ln
               for ln in rec.lines):
        fail(f"{label}: the log does not name the replicas route")
    runs.append(counts)
    del model
    torch.cuda.empty_cache()
    _check_no_jax()

    # NUTS on (2,1): the flagship's per-rank replicas, each adapting alone
    # and pooled, and the pooled route of fixed completeness
    nkw = dict(num_warmup=GRID_NUTS_WARMUP, nchains=GRID_NUTS_CHAINS)
    model = _flagship_model(dev, mesh_walkers=2, nsteps=GRID_NUTS_STEPS)
    label = f"grid rank {rank} fit --sampler nuts (2,1)"
    counts, rec, step = _grid_nuts(label, model, "free", nkw,
                                   ref["med_free"], say)
    if not any("per-rank replicas over the 2-rank grid" in ln
               and "independent per-rank adaptation" in ln
               for ln in rec.lines):
        fail(f"{label}: the log does not name the replicas route")
    runs.append(counts)
    label = f"grid rank {rank} fit --sampler nuts --nuts-pooled (2,1)"
    counts, rec, step = _grid_nuts(label, model, "free", dict(
        nkw, pooled=True), ref["med_free"], say)
    if ".." in step:
        fail(f"{label}: the ranks' step sizes differ ({step})")
    runs.append(counts)
    del model
    model = _flagship_model(dev, mesh_walkers=2, fix_comp=True,
                            nsteps=GRID_NUTS_STEPS)
    label = f"grid rank {rank} fit -fc --sampler nuts (2,1)"
    counts, rec, _ = _grid_nuts(label, model, "fixed", nkw,
                                ref["med_fixed"], say)
    if not any("NUTS chains sharded over the 2 walker ranks" in ln
               for ln in rec.lines):
        fail(f"{label}: the log does not name the pooled route")
    runs.append(counts)
    del model
    torch.cuda.empty_cache()
    _check_no_jax()
    shutdown()
    print(json.dumps({"grid_rank": rank, "launches": {
        k: sum(r[k] for r in runs) for k in KERNELS}}))
    return 0


CALIB = "calib"             # the calibration replicates' path (phase 18)
# the value kernel of each replicate family, its feature map, and the
# widths its fits give it (the half-step's and the start's)
CALIB_FAMILIES = {"sbc": ("fixed_lnlike", cl._features, (16, 32)),
                  "z": ("z_lnlike", cl._features_z, (16, 32)),
                  "hier": ("hier_lnlike", cl._features_hier, (24, 48)),
                  "free": ("free_lnlike", cl._features, (32, 64))}
CALIB_WIDTHS = (16, 24, 32, 48, 64)
CALIB_DEVICE = "cuda:0"     # the replicates' card
# the examples each run once on the card, in processes of their own, one
# after the other: arguments and a line of the table
EXAMPLES = {
    "quickstart": ([], "[[Schechter fit]]"),
    "model_comparison": ([], "  ln Bayes factor (single vs z) = "),
    "sbc_check": (["2"], "rank histograms over {0..7}"),
    "coverage_check": (["2", "--free", "--pallas"],
                       "=== coverage over 2 replicates"),
    "coverage_check_z": (["2"], "=== z-model coverage over 2 replicates"),
}
# what an example must launch (its family's value kernels; quickstart's
# NUTS also the fixed value+gradient kernel), and exactly where a count
# follows from its replicates: K x (2 x steps + 1)
EXAMPLE_LAUNCHES = {
    "quickstart": {"fixed_lnlike": None, "fixed_lnlike_vg": None},
    "model_comparison": {"fixed_lnlike": None, "z_lnlike": None},
    "sbc_check": {"fixed_lnlike": 2 * (2 * 600 + 1)},
    "coverage_check": {"free_lnlike": 2 * (2 * 1500 + 1)},
    "coverage_check_z": {"z_lnlike": 2 * (2 * 1500 + 1)},
}
EXAMPLE_SECONDS = 600       # what the five examples' processes may take


def _calib_setups(dev):
    """The first replicate of each family, set up as the calibration path
    runs it (its truth from a fresh copy of the gate's ``rng``): the
    model, and its starts."""
    from lumfuncmcmc_tpu_torch.utils import calibration as cal
    rng = np.random.default_rng
    sbc = cal._sbc_setup(0, rng(7), 32, 400, None, 41, dev)
    z = cal._z_setup(0, rng(17), 800, 32, 800, 1024, 41, dev)
    hier = cal._hier_setup(0, rng(23), 2, 48, 800, 41, dev)
    free = cal._coverage_setup(0, rng(7), True, True, False, 1500, 64, None,
                               2048, dev)
    return {"sbc": sbc[:2], "z": z[:2], "hier": hier[:2], "free": free[:2]}


def _calib_widths(dev):
    """Each family's value kernel on the data of its first replicate
    (gauss quadrature; the hierarchical model at 2 fields) at the
    replicates' widths, the half-step's and the start's: against its
    plain version (``RTOL_KERNEL``), two launches bit for bit, tickets
    back at 0. Launches made here are not the path's: the counters are
    set to 0 before each replicate."""
    for fam, (model, pos0) in _calib_setups(dev).items():
        kname, features, widths = CALIB_FAMILIES[fam]
        lnprob = model.lnprob_batch()
        if lnprob.engine != "cuda":
            fail(f"calib {fam}: the replicate's engine is {lnprob.engine}, "
                 "not the CUDA kernel")
        kernel = getattr(cl, kname)
        plain = getattr(cl, kname + "_reference")
        data = lnprob.data
        for w in widths:
            feats = features(pos0[:w].float(), data, model.layout,
                             torch.float32).float()
            got, again = kernel(feats, data), kernel(feats, data)
            ref = plain(feats, data)
            torch.cuda.synchronize()
            err = _rel(got, ref)
            print(f"calib {kname} W={w} on the {fam} replicate's data "
                  f"({int(model.ctx.lum.shape[0])} sources, "
                  f"{len(model.cfg.Flim)} fields, gauss-"
                  f"{model.cfg.size_ln or 32}): kernel vs plain max rel "
                  f"{err:.3e}")
            if not (torch.isfinite(got).all() and torch.equal(got, again)):
                fail(f"calib {kname} W={w}: non-finite, or two launches "
                     "differ")
            if data.vg_tickets.any():
                fail(f"calib {kname} W={w}: tickets not back at 0")
            if err > RTOL_KERNEL:
                fail(f"calib {kname} W={w}: kernel vs plain {err:.3e} > "
                     f"{RTOL_KERNEL}")


def _calib_replicate(label, fn, kname, steps, k, rng, rec, **kw):
    """One replicate ``fn(k, rng, device=cuda, **kw)`` with every launch
    counter set to 0 just before and read just after: exactly 2 x
    ``steps`` + 1 launches of ``kname`` and none of another kernel, a
    finite chain. Prints its wall and its setup/sampling split (the
    replicate's log line). Returns (result, counts, chain)."""
    from lumfuncmcmc_tpu_torch.utils import calibration as cal
    chains, real = [], cal._run

    def run(lnprob, pos0, generator, n, move="stretch"):
        if lnprob.engine != "cuda":
            fail(f"{label} {k}: engine {lnprob.engine}, not the CUDA kernel")
        chains.append(real(lnprob, pos0, generator, n, move))
        return chains[-1]

    for name in KERNELS:
        _kernel(name).launches = 0
    cal._run = run
    t0 = time.perf_counter()
    try:
        out = fn(k, rng, device=torch.device(CALIB_DEVICE), **kw)
    finally:
        cal._run = real
    wall = time.perf_counter() - t0
    counts = {name: _kernel(name).launches for name in KERNELS}
    want = {name: 0 for name in KERNELS}
    want[kname] = 2 * steps + 1
    if counts != want:
        fail(f"{label} {k}: launches "
             f"{ {n: v for n, v in counts.items() if v} }, want "
             f"{kname} {want[kname]} and nothing else")
    if len(chains) != 1 or not np.isfinite(chains[0]).all():
        fail(f"{label} {k}: no run, or a non-finite chain")
    split = [ln for ln in rec.lines if ln.startswith("calibration ")
             and f"replicate {k}:" in ln and "sampling" in ln]
    print(f"{label} {k}: wall {wall:.3f} s; {split[-1] if split else ''}",
          flush=True)
    return out, counts, chains[0]


def _hits(covers, names):
    return ({p: sum(c[p][0] for c in covers) for p in names},
            {p: sum(c[p][1] for c in covers) for p in names})


def _calib_gates(rec, add):
    """``tests/test_calibration.py``'s three ``-m slow`` gates at their
    K, sizes, seeds and bounds (its docstrings give the false-alarm
    rates: < 2%, < 0.5%, < 1%), each replicate through its CUDA value
    kernel."""
    from lumfuncmcmc_tpu_torch.utils import calibration as cal
    # single-epoch: K = 12, 32 x 400, size_ln 41, rng 7
    rng = np.random.default_rng(7)
    ranks, covers = [], []
    for k in range(12):
        (r, cover, _, _), counts, _ = _calib_replicate(
            "calib sbc", cal.sbc_replicate, "fixed_lnlike", 400, k, rng,
            rec, nwalkers=32, nsteps=400, M=7, size_ln=41)
        add(counts)
        ranks.append(r)
        covers.append(cover)
    ranks = np.asarray(ranks)
    h68, h95 = _hits(covers, cal.PARAMS)
    for i, p in enumerate(cal.PARAMS):
        mean_rank = float(ranks[:, i].mean())
        print(f"calib sbc gate {p}: 68% {h68[p]}/12, 95% {h95[p]}/12, "
              f"mean rank {mean_rank:.2f}")
        if h68[p] < 4 or h95[p] < 7 or not 1.5 <= mean_rank <= 5.5:
            fail(f"calib sbc gate {p}: 68% {h68[p]}/12 (>= 4), 95% "
                 f"{h95[p]}/12 (>= 7), mean rank {mean_rank:.2f} "
                 "([1.5, 5.5])")
    if sum(h68.values()) > 33:
        fail(f"calib sbc gate: pooled 68% {sum(h68.values())}/36 > 33")
    # redshift-evolving: K = 8 at the defaults, rng 17
    rng = np.random.default_rng(17)
    covers = []
    for k in range(8):
        (cover, names), counts, _ = _calib_replicate(
            "calib z", cal.coverage_replicate_z, "z_lnlike", 800, k, rng,
            rec)
        add(counts)
        covers.append(cover)
    h68, h95 = _hits(covers, names)
    print(f"calib z gate: 68% {h68}, 95% {h95} of 8")
    bad = [p for p in names if h68[p] < 1 or h95[p] < 5]
    if bad or not 24 <= sum(h68.values()) <= 55:
        fail(f"calib z gate: {bad} under the floors (68% >= 1, 95% >= 5) "
             f"or pooled 68% {sum(h68.values())}/56 outside [24, 55]")
    # hierarchical: K = 10 at the defaults, rng 23
    rng = np.random.default_rng(23)
    ranks, covers = [], []
    for k in range(10):
        (r, cover, _, _), counts, _ = _calib_replicate(
            "calib hier", cal.sbc_replicate_h, "hier_lnlike", 800, k, rng,
            rec)
        add(counts)
        ranks.append(r)
        covers.append(cover)
    ranks = np.asarray(ranks)
    names = list(covers[0])
    h68, h95 = _hits(covers, names)
    for i, p in enumerate(names):
        mean_rank = float(ranks[:, i].mean())
        print(f"calib hier gate {p}: 68% {h68[p]}/10, 95% {h95[p]}/10, "
              f"mean rank {mean_rank:.2f}")
        if h68[p] < 2 or h95[p] < 6 or not 1.0 <= mean_rank <= 6.0:
            fail(f"calib hier gate {p}: 68% {h68[p]}/10 (>= 2), 95% "
                 f"{h95[p]}/10 (>= 6), mean rank {mean_rank:.2f} "
                 "([1.0, 6.0])")


def _calib_free(rec, add):
    """``coverage_replicate(free=True, pallas=True)``: two replicates with
    ``move="mix"`` and two with ``init_map=True`` (no statistics at K =
    2): chains finite and inside the prior box, a cover entry for each of
    the nine parameters, and for ``init_map`` which start ran."""
    from lumfuncmcmc_tpu_torch.utils import calibration as cal
    layout = ThetaLayout.from_config(LFConfig(min_comp_frac=0.5))
    lo, hi = np.asarray(layout.lo), np.asarray(layout.hi)
    for label, kw in (("mix", {"move": "mix"}), ("init_map",
                                                 {"init_map": True})):
        rng = np.random.default_rng(7)
        for k in range(2):
            cover, counts, chain = _calib_replicate(
                f"calib free {label}", cal.coverage_replicate, "free_lnlike",
                1500, k, rng, rec, free=True, pallas=True, **kw)
            add(counts)
            if not ((chain > lo) & (chain < hi)).all():
                fail(f"calib free {label} {k}: the chain left the box")
            if list(cover) != list(layout.names):
                fail(f"calib free {label} {k}: cover names {list(cover)}")
            print(f"calib free {label} {k}: 68% covered "
                  f"{[p for p in cover if cover[p][0]]}")
            if label == "init_map":
                start = [ln for ln in rec.lines
                         if ln.startswith(f"calibration replicate {k}: ")]
                if not start:
                    fail(f"calib free init_map {k}: no start logged")
                print(f"calib free init_map {k}: {start[-1]}")


def _start_example(name, workdir):
    args, _ = EXAMPLES[name]
    out = open(os.path.join(workdir, f"example_{name}.out"), "w+")
    err = open(os.path.join(workdir, f"example_{name}.err"), "w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--example", name,
         *args], stdout=out, stderr=err, cwd=workdir)
    return proc, out, err


def _finish_example(name, started, deadline):
    """Wait for an example's process; its exit code 0, its table, no JAX
    (``run_example`` checked) and its launches. Returns the counts."""
    proc, out, err = started
    try:
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
        out.seek(0)
        err.seek(0)
        lines = out.read().splitlines()
        tail = err.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()
    if rc != 0:
        fail(f"example {name} returned {rc}: {tail}")
    table = EXAMPLES[name][1]
    if not any(ln.startswith(table) for ln in lines):
        fail(f"example {name}: no '{table}' line in its output")
    got = json.loads(lines[-1])
    print(f"example {name} {' '.join(EXAMPLES[name][0])}: wall "
          f"{got['wall']:.1f} s; its output:")
    print("\n".join(lines[:-1]))
    for kname, n in EXAMPLE_LAUNCHES[name].items():
        if got["launches"][kname] == 0 or (
                n is not None and got["launches"][kname] != n):
            fail(f"example {name}: {got['launches'][kname]} launches of "
                 f"{kname} (want {n or '> 0'})")
    return got["launches"]


def run_example(name, args):
    """An example's ``main`` in this process (``python3 chip_smoke.py
    --example NAME ARGS``) on the card, every launch counter at 0 before
    it and read after; the last line of its output is one JSON line with
    its wall and the counts."""
    import importlib
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    mod = importlib.import_module(f"lumfuncmcmc_tpu_torch.examples.{name}")
    for k in KERNELS:
        _kernel(k).launches = 0
    t0 = time.perf_counter()
    rc = mod.main(list(args))
    wall = time.perf_counter() - t0
    counts = {k: _kernel(k).launches for k in KERNELS}
    _check_no_jax()
    print(json.dumps({"example": name, "wall": wall, "launches": counts}))
    return rc


def run_calib(workdir, has_mpl):
    """Phase 18, the calibration replicates on the card: each family's
    value kernel on its first replicate's data at the replicates' widths
    (:func:`_calib_widths`), ``tests/test_calibration.py``'s three gates
    (:func:`_calib_gates`) and the free model's ``pallas=True`` replicates
    (:func:`_calib_free`), each replicate's launches exact; then the five
    examples, one at a time, each in a process of its own. Returns the
    launch counts summed over the replicates and the examples."""
    # one busy process at a time, below the other paths' priority (its
    # examples inherit it): the grid's ranks beside it are host-bound and
    # their collectives wait on the slowest rank
    os.nice(10)
    t0 = time.perf_counter()
    rec = _Records()
    log = logging.getLogger("lumfuncmcmc_tpu_torch")
    log.addHandler(rec)
    total = {k: 0 for k in KERNELS}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    try:
        _calib_widths(torch.device(CALIB_DEVICE))
        _calib_gates(rec, add)
        _calib_free(rec, add)
    finally:
        log.removeHandler(rec)
    print(f"calib replicates: {time.perf_counter() - t0:.1f} s")
    exdir = os.path.join(workdir, "examples")
    os.makedirs(exdir, exist_ok=True)
    deadline = time.monotonic() + EXAMPLE_SECONDS
    for name in EXAMPLES:
        add(_finish_example(name, _start_example(name, exdir), deadline))
    print(f"calib path: {time.perf_counter() - t0:.1f} s")
    return total


def _check_no_jax():
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "lumfuncmcmc_tpu")]
    if bad:
        fail(f"the port imported {sorted(bad)[:5]}")


def run_path(label, workdir, has_mpl):
    """One fit path in this process: its stretch fit, its NUTS fit, the
    stretch fit rerun with the path's model-comparison flags, and its
    fresh ``--map`` / ``--init-map`` run where it has one. Prints their
    lines, then one JSON line with the path's launch counts (``python3
    chip_smoke.py --path LABEL WORKDIR HAS_MPL``, which :func:`phase_paths`
    starts)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if label == LONG:
        runs = [run_long(workdir, has_mpl)]
    elif label == CALIB:
        runs = [run_calib(workdir, has_mpl)]
    elif label == GRID:
        runs = [run_grid(workdir, has_mpl)]
    else:
        counts, col = phase_fit(label, workdir, has_mpl)
        runs = [counts, phase_nuts(label, workdir, has_mpl, col),
                phase_compare(label, workdir, has_mpl)]
        if PATHS[label].also:
            runs.append(phase_also(label, workdir, has_mpl, col))
    _check_no_jax()
    print(json.dumps({"path": label, "launches": {
        k: sum(r[k] for r in runs) for k in KERNELS}}))
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
        for label in [*PATHS, LONG, GRID, CALIB]:
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
    if sys.argv[1:2] == ["--example"]:
        return run_example(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--grid-rank"]:
        return grid_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         sys.argv[5] == "1")
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
    for fam, d in phase_ladder(dev).items():
        summary[f"{fam}_lnlike"]["ladder_dlnz"] = d
    print(f"kernel phases: {time.perf_counter() - t_start:.1f} s")
    api = phase_api(dev)
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_paths(workdir, has_mpl)
        phase_ic_commands(workdir)
        phase_vmax(workdir, has_mpl)
    _check_no_jax()
    launches["roofline_chain"] = roof["launches"]
    for name, n in api.items():
        launches[name] += n
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
                  "dlnp_err", "resident_dlnp_err", "ladder_dlnz",
                  "lnprob_call_ms",
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
