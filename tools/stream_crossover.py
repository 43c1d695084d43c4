"""Resident vs streaming free-completeness kernels on one card, the table
that sets ``STREAM_MIN_SOURCES``, and the same-mix roofline.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/stream_crossover.py [--sizes 2000,20000,...,1200000]

For each catalog size (``make_catalog(n_target=N, seed=7)`` under the
flagship config with gauss-32 quadrature, the JAX benchmark's stream
catalog at N = 1,200,000: 1,019,385 sources) it checks ``free_lnlike``,
``free_stream_lnlike`` and their value+gradient twins against their
plain versions at thetas near the truth, then times them on the card
(median of CUDA-graph replays between CUDA events): the value kernels at
W = 50 (the stretch half-ensemble), the value+gradient kernels at W = 8
(the NUTS chains) and 256, and one whole lnprob call of each engine
(features, kernel, collapse, mask) at W = 50. Then, for each engine, the
error against the float64 eager lnprob in the lnp differences of 32
close pairs of thetas (float64 thetas, as under ``use_x64``): the
precision the gate decides. Then ``transcendental_peak``. Prints one line
per measurement, the card's name and power limit, and the JSON summary
last. Imports only the port.

    python3 tools/stream_crossover.py --emulate [--sizes 20000,...]

runs on the CPU instead (no card; the table behind
``FLOAT32_MAX_SOURCES``): for each family of resident kernels (``fit
-fc``, ``fitz``, ``fith`` and free completeness) and catalog size, the
lnp-difference error of the same 32 close pairs against the float64 eager
lnprob, (a) for a float64 run (float64 context and thetas, the kernels'
plain float32 versions: float32 features and terms, float64 sums and
collapsed terms, as the card computes them) and (b) for a float32 run
(float32 context and thetas, the value cast to float32 at the end).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lumfuncmcmc_tpu_torch import LFConfig  # noqa: E402
from lumfuncmcmc_tpu_torch.models.context import build_context  # noqa: E402
from lumfuncmcmc_tpu_torch.models.hierarchical import (  # noqa: E402
    ThetaLayoutH, make_lnprob_h)
from lumfuncmcmc_tpu_torch.models.likelihood import (  # noqa: E402
    ThetaLayout, make_lnprob)
from lumfuncmcmc_tpu_torch.models.likelihood_z import (  # noqa: E402
    ThetaLayoutZ, make_lnprob_z)
from lumfuncmcmc_tpu_torch.ops import _build  # noqa: E402
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl  # noqa: E402
from lumfuncmcmc_tpu_torch.ops.roofline import (  # noqa: E402
    roofline_chain, roofline_chain_reference, transcendental_peak)
from lumfuncmcmc_tpu_torch.utils.synth import (  # noqa: E402
    apply_completeness_cut, make_catalog)


def device_ms(fn, inner=10, reps=9):
    """Median device time of one ``fn()``: ``inner`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events."""
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


def call_ms(fn, inner=20, reps=7):
    """Median stream time per eager call, host launches included."""
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


def central_thetas(cat, cfg, layout, w, gen, dev, scale=0.002):
    """``w`` thetas within ~``scale`` of the box width of the truth."""
    tt = cat["theta_true"]
    c = torch.tensor([tt["Lstar"], tt["phistar"], tt["sch_al"], *cfg.Flim,
                      cfg.alpha], dtype=torch.float64, device=dev)
    lo, hi = layout.bounds_arrays(torch.float64, dev)
    return c + scale * (hi - lo) * torch.randn(
        (w, c.numel()), generator=gen, dtype=torch.float64, device=dev)


def close_pairs(cat, cfg, layout, gen, dev):
    """32 thetas within ~0.1% of the box width of the truth, then each
    moved by ~6e-5 of the width (``chip_smoke.py``'s close pairs)."""
    base = central_thetas(cat, cfg, layout, 32, gen, dev, 0.001)
    lo, hi = layout.bounds_arrays(torch.float64, dev)
    return torch.cat([base, base + 6e-5 * (hi - lo) * torch.randn(
        base.shape, generator=gen, dtype=torch.float64, device=dev)])


def dlnp(v):
    """The lnp differences of :func:`close_pairs`' 32 pairs."""
    return v[32:] - v[:32]


def in_rows(fn, th, rows):
    """``fn(th)`` a block of ``rows`` thetas at a time."""
    return torch.cat([fn(th[i:i + rows]) for i in range(0, len(th), rows)])


def check(name, got, ref, lnl_scale, cols):
    """Max abs value error (float64 terms) and the gradient rule."""
    if cols:
        err_v = float((got[:, 0].double() - ref[:, 0].double()).abs().max())
        g, r = got[:, 1:].double(), ref[:, 1:].double()
        den = torch.maximum(r.abs(), 1e-3 * r.abs().amax(dim=1,
                                                         keepdim=True))
        err_g = float(((g - r).abs() / den).max())
    else:
        err_v = float((got.double() - ref.double()).abs().max())
        err_g = 0.0
    print(f"  {name}: kernel vs plain max abs {err_v:.3e} (|lnL| ~ "
          f"{lnl_scale:.3e}), gradient {err_g:.3e}")
    if not (np.isfinite(err_v) and err_v <= 1e-4 * lnl_scale
            and err_g <= 2e-3):
        raise SystemExit(f"FAILED: {name} disagrees with its plain version")
    return err_v, err_g


def emulate(sizes):
    """The CPU emulation of the accept step's precision per family of
    resident kernels (module docstring); one line per catalog size."""
    base = LFConfig(min_comp_frac=0.5, quadrature="gauss")
    fams = (("fixed", ThetaLayout, make_lnprob, "single"),
            ("z", ThetaLayoutZ, make_lnprob_z, "z"),
            ("hier", ThetaLayoutH, make_lnprob_h, "hier"),
            ("free", ThetaLayout, make_lnprob, "single"))
    rows = []
    for n_target in sizes:
        cat = apply_completeness_cut(
            make_catalog(base, n_target=n_target, seed=7), base)
        tt = cat["theta_true"]
        vals = {"Lstar": tt["Lstar"], "phistar": tt["phistar"],
                "sch_al": tt["sch_al"], "alpha": base.alpha,
                "mu_L": tt["Lstar"], "sig_L": 0.3, "mu_p": tt["phistar"],
                "sig_p": 0.5}
        for k in (1, 2, 3):
            vals[f"L{k}"], vals[f"phi{k}"] = tt["Lstar"], tt["phistar"]
        for i, flim in enumerate(base.Flim):
            vals[f"Flim_{i}"] = flim
        kw = dict(z=cat["z"], flux=cat["flux"], flux_e=cat["flux_e"],
                  field_id=cat["field_id"])
        row = {"n_target": n_target, "nsrc": len(cat["z"])}
        for fam, layout_cls, eager, model in fams:
            cfg = base.replace(fix_comp=fam != "free")
            ctx64 = build_context(cfg, dtype=torch.float64, **kw)[1]
            ctx32 = build_context(cfg, dtype=torch.float32, **kw)[1]
            layout = layout_cls.from_config(cfg)
            center = torch.tensor(
                [vals[n.split("_")[0] if n.split("_")[0] in
                      ("Lstar", "phistar") else n] for n in layout.names],
                dtype=torch.float64)
            lo, hi = layout.bounds_arrays(torch.float64, "cpu")
            gen = torch.Generator().manual_seed(5)
            base_th = center + 0.001 * (hi - lo) * torch.randn(
                (32, center.numel()), generator=gen, dtype=torch.float64)
            th = torch.cat([base_th, base_th + 6e-5 * (hi - lo) * torch.randn(
                base_th.shape, generator=gen, dtype=torch.float64)])
            th = th.float().double()        # exact in both runs
            want = eager(ctx64, layout)(th)
            keep = cl.STREAM_MIN_SOURCES
            cl.STREAM_MIN_SOURCES = 10**12      # the resident kernels
            try:
                route = cl._route(ctx64, layout, model, False,
                                  kdtype=torch.float32)
                vg = cl._route(ctx64, layout, model, True, data=route.data,
                               kdtype=torch.float32)
                f, _, aux = route.features(th)
                extra = (0.0 if route.collapse is None
                         else route.collapse(f, aux))
                f64_run = route.kernel(f) + extra
                f64_vg = vg.kernel(f) + extra
                f32_run = cl._lnprob(cl._route(ctx32, layout, model, False))(
                    th.float()).double()
            finally:
                cl.STREAM_MIN_SOURCES = keep
            row[fam] = {
                "float64_run": float((dlnp(f64_run) - dlnp(want)).abs().max()),
                "float64_run_vg": float(
                    (dlnp(f64_vg) - dlnp(want)).abs().max()),
                "float32_run": float((dlnp(f32_run) - dlnp(want)).abs().max()),
                "abs_lnl": float(want.abs().max())}
        print(f"N = {row['nsrc']} sources ({n_target} drawn), |lnL| ~ "
              f"{row['fixed']['abs_lnl']:.4e}: " + "; ".join(
                  f"{fam} {row[fam]['float64_run']:.4f} / "
                  f"{row[fam]['float64_run_vg']:.4f} (vg) / "
                  f"{row[fam]['float32_run']:.4f} (float32 run)"
                  for fam, *_ in fams), flush=True)
        rows.append(row)
    print(json.dumps({"emulation": rows}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default=None,
                    help="comma-separated n_target values (default: "
                         "2000,...,1200000 on the card; 20000,...,200000 "
                         "with --emulate)")
    ap.add_argument("--emulate", action="store_true",
                    help="the CPU emulation of the resident kernels' "
                         "accept-step precision per family (no card)")
    args = ap.parse_args()
    if args.emulate:
        torch.set_num_threads(min(4, os.cpu_count() or 1))
        return emulate([int(s) for s in (
            args.sizes or "20000,30000,36000,40000,44000,50000,80000,"
            "200000").split(",")])
    args.sizes = args.sizes or ("2000,20000,50000,80000,100000,200000,"
                                "400000,700000,1200000")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    path = _build.build()
    print(f"kernel build {_build.build_seconds:.2f} s -> {path}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    _build.load_library()

    cfg = LFConfig(min_comp_frac=0.5, quadrature="gauss")
    layout = ThetaLayout.from_config(cfg)
    rows = []
    for n_target in (int(s) for s in args.sizes.split(",")):
        cat = apply_completeness_cut(
            make_catalog(cfg, n_target=n_target, seed=7), cfg)
        _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                               flux_e=cat["flux_e"],
                               field_id=cat["field_id"], device=dev,
                               dtype=torch.float64)
        nsrc = len(cat["z"])
        res = cl.prepare_cuda_data(ctx, False, cfg.fcmin,
                                   dtype=torch.float32)
        st = cl.prepare_cuda_stream_data(ctx, cfg.fcmin,
                                         dtype=torch.float32)
        npieces = {p: t.shape[0] for p, t, _ in res.vg_tables}
        tile, piece = cl._vg_geometry(npieces, 50, cl._sm_count(dev.index),
                                      cl._tiles("free_lnlike"))
        print(f"N = {nsrc} sources ({n_target} drawn), resident value "
              f"kernel at W = 50: {npieces[piece]} pieces of up to {piece}, "
              f"tiles of {tile}; {int(st.runs.shape[0])} stream runs of up "
              f"to {st.run_pieces} tiles, waves {st.waves}")
        row = {"n_target": n_target, "nsrc": nsrc}
        gen = torch.Generator(device=dev).manual_seed(n_target)
        for w, vg in ((50, False), (8, True), (256, True)):
            th = central_thetas(cat, cfg, layout, w, gen, dev)
            fr = cl._features(th.float(), res, layout,
                              torch.float32).float()
            fs = cl._features_stream(th, st, layout,
                                     torch.float32).float().contiguous()
            kr = cl.free_lnlike_vg if vg else cl.free_lnlike
            ks = cl.free_stream_lnlike_vg if vg else cl.free_stream_lnlike
            pr = cl.free_lnlike_vg_reference if vg else \
                cl.free_lnlike_reference
            ps = cl.free_stream_lnlike_vg_reference if vg else \
                cl.free_stream_lnlike_reference
            got_r, ref_r = kr(fr, res), pr(fr, res)
            got_s, ref_s = ks(fs, st), ps(fs, st)
            torch.cuda.synchronize()
            scale = float((ref_r[:, 0] if vg else ref_r).abs().max())
            tag = f"W={w} {'vg' if vg else 'value'}"
            check(f"{kr.__name__} {tag}", got_r, ref_r, scale, vg)
            check(f"{ks.__name__} {tag}", got_s, ref_s, scale, vg)
            row[f"resident_{tag}_ms"] = device_ms(lambda: kr(fr, res))
            row[f"stream_{tag}_ms"] = device_ms(lambda: ks(fs, st))
            print(f"  {tag}: resident {row[f'resident_{tag}_ms']:.4f} ms; "
                  f"stream {row[f'stream_{tag}_ms']:.4f} ms")
        th = central_thetas(cat, cfg, layout, 50, gen, dev)
        pairs = close_pairs(cat, cfg, layout, gen, dev)
        want = in_rows(make_lnprob(ctx, layout), pairs, 16)
        for label, gate in (("resident", 10**12), ("stream", 0)):
            keep = cl.STREAM_MIN_SOURCES
            cl.STREAM_MIN_SOURCES = gate
            fn = cl.make_cuda_lnprob(ctx, layout)
            cl.STREAM_MIN_SOURCES = keep
            row[f"{label}_lnprob_call_ms"] = call_ms(lambda: fn(th))
            row[f"{label}_dlnp_err"] = float(
                (dlnp(fn(pairs)) - dlnp(want)).abs().max())
        print(f"  whole lnprob call at W=50: resident "
              f"{row['resident_lnprob_call_ms']:.4f} ms, stream "
              f"{row['stream_lnprob_call_ms']:.4f} ms; lnp differences of "
              f"32 close pairs (|dlnp| {float(dlnp(want).abs().min()):.3f}"
              f" to {float(dlnp(want).abs().max()):.3f}) vs float64 eager: "
              f"max error resident {row['resident_dlnp_err']:.4e}, stream "
              f"{row['stream_dlnp_err']:.4e}")
        rows.append(row)
        del ctx, res, st
        torch.cuda.empty_cache()

    x = (0.05 + 0.9 * torch.rand((256, 1024), device=dev))
    err = float((roofline_chain(x, 8) - roofline_chain_reference(x, 8)
                 ).abs().max())
    print(f"roofline_chain vs plain after 8 iterations: max abs {err:.3e}")
    if not err <= 1e-5:
        raise SystemExit("FAILED: roofline_chain disagrees with its plain "
                         "version")
    peak = transcendental_peak(dev)
    print(f"same-mix peak: {peak['elements_per_sec']:.4e} elements/s, "
          f"{peak['transcendentals_per_sec']:.4e} transcendentals/s "
          f"({peak['per_iter_s'] * 1e6:.3f} us per iteration of "
          f"{peak['rows'] * peak['cols']} elements)")
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "rows": rows, "roofline": peak, "roofline_err": err}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
