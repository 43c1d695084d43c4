"""The NUTS paths' value+gradient kernels (``free_lnlike_vg`` of ``fit
--sampler nuts``, ``fixed_lnlike_vg`` of ``fit -fc --sampler nuts``,
``z_lnlike_vg`` of ``fitz --sampler nuts``, ``hier_lnlike_vg`` of ``fith
--sampler nuts``) against an earlier two-pass design of the same kernels,
in turns on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/vg_turns.py --old DIR [--widths 1,8,256] [--families F,..]
                              [--sweep] [--ablate]

``DIR`` holds the earlier design's ``csrc/`` (for instance a ``git
archive`` of an earlier commit unpacked under ``_archive/``, which
``.gitignore`` lists). Each family whose two-pass kernels
(``*_vg_partials`` and ``*_vg_finish``) it holds is compared (or those of
``--families``); its sources are built into a library of their own under
``lumfuncmcmc_tpu_torch/_build/``, with C entry points appended to their
copies: each old kernel's partial pass alone, its finish pass alone, and a
pair of empty kernels. On the fits' own catalog
(``fit --synthetic 2000``'s: ``free_lnlike_vg`` at trapz-101, the others at
trapz-201) and at each walker batch it checks the old call and the current
wrapper against the plain version and each other (values rtol 1e-4,
gradients 2e-3 by ``_grad_close``) and two launches of each on one input
bit for bit; then times, in ``chip_smoke.py``'s ``_device_ms`` harness (a
CUDA graph of 20 calls replayed between CUDA events): the old call and
the current one in turns (old, new, new, old), the old partial and finish
passes alone, one and two empty kernels; and, under ``torch.profiler``,
each kernel's own device time per call. With ``--sweep`` it also times
the current kernels at every (walker tile, piece) they are built for (the
z model's at its rule's row phases and at one), and with ``--ablate``
builds of them with parts left out (``ABLATIONS``). Prints one line per
measurement, the card's name and power limit, and writes the JSON
summary to ``chiprun_out/vg_turns.json``. Imports only the port.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from lumfuncmcmc_tpu_torch.models.likelihood import sample_init  # noqa: E402
from lumfuncmcmc_tpu_torch.ops import _build  # noqa: E402
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl  # noqa: E402

# appended to the earlier design's sources (its kernels' own names and
# launch shapes): each family's partial and finish passes alone, with one C
# signature for every finish
SPLIT_FREE = r"""
extern "C" int split_free_vg_partials(
        const float* feats, int nwalkers, int nfeat, int nfields,
        const float* g_logf, const float* g_a, const float* g_p,
        const float* g_r, const float* g_w, const float* s_logf,
        const float* s_a, const float* s_p, const float* s_r,
        const float* s_lnom0, const float* s_mask, const int* chunks,
        int nchunks, int fcmin, double* partial, void* stream) {
    free_vg_partials<<<dim3(nchunks, nwalkers), THREADS, 0,
                       (cudaStream_t)stream>>>(
        feats, nfeat, nfields, g_logf, g_a, g_p, g_r, g_w, s_logf, s_a, s_p,
        s_r, s_lnom0, s_mask, (const int4*)chunks, nchunks, fcmin, partial);
    return (int)cudaGetLastError();
}
extern "C" int split_free_vg_finish(
        const double* partial, const int* chunks, int nchunks,
        const float* feats, int nwalkers, int nfeat, int nfields,
        double* out, void* stream) {
    free_vg_finish<<<nwalkers, (1 + nfeat + 31) / 32 * 32, 0,
                     (cudaStream_t)stream>>>(
        partial, (const int4*)chunks, nchunks, feats, nfeat, nfields, out);
    return (int)cudaGetLastError();
}
"""
SPLIT_HIER = r"""
extern "C" int split_hier_vg_partials(
        const float* feats, int nwalkers, int nfeat, int nfields,
        const float* g_a, const float* g_p, const float* g_w,
        const int* chunks, int nchunks, double* partial, void* stream) {
    hier_vg_partials<<<dim3(nchunks, nwalkers), THREADS, 0,
                       (cudaStream_t)stream>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    return (int)cudaGetLastError();
}
extern "C" int split_hier_vg_finish(
        const double* partial, const int* chunks, int nchunks,
        const float* feats, int nwalkers, int nfeat, int nfields,
        double* out, void* stream) {
    hier_vg_finish<<<nwalkers, (nfields * 3 + 31) / 32 * 32, 0,
                     (cudaStream_t)stream>>>(
        partial, (const int4*)chunks, nchunks, feats, nfeat, nfields, out);
    return (int)cudaGetLastError();
}
"""
SPLIT_FIXED = r"""
extern "C" int split_fixed_vg_partials(
        const float* feats, int nwalkers, int nfeat, const float* g_a,
        const float* g_p, const float* g_w, const int* chunks, int nchunks,
        double* partial, void* stream) {
    fixed_vg_partials<<<dim3(nchunks, nwalkers), THREADS, 0,
                        (cudaStream_t)stream>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    return (int)cudaGetLastError();
}
extern "C" int split_fixed_vg_finish(
        const double* partial, const int* chunks, int nchunks,
        const float* feats, int nwalkers, int nfeat, int nfields,
        double* out, void* stream) {
    fixed_vg_finish<<<nwalkers, 32, 0, (cudaStream_t)stream>>>(
        partial, nchunks, feats, nfeat, out);
    return (int)cudaGetLastError();
}
"""
SPLIT_Z = r"""
extern "C" int split_z_vg_partials(
        const float* feats, int nwalkers, int nfeat, int s_l, int s_z,
        const float* g_a, const float* g_p, const float* g_w,
        const float* n_dz, const float* n_dz2, const float* s_a,
        const float* s_dz, const float* s_dz2, const float* s_lnom0,
        const float* s_mask, const int* chunks, int nchunks,
        double* partial, void* stream) {
    z_vg_partials<<<dim3(nchunks, nwalkers), THREADS, 0,
                    (cudaStream_t)stream>>>(
        feats, nfeat, s_l, s_z, g_a, g_p, g_w, n_dz, n_dz2, s_a, s_dz, s_dz2,
        s_lnom0, s_mask, (const int4*)chunks, nchunks, partial);
    return (int)cudaGetLastError();
}
extern "C" int split_z_vg_finish(
        const double* partial, const int* chunks, int nchunks,
        const float* feats, int nwalkers, int nfeat, int nfields,
        double* out, void* stream) {
    z_vg_finish<<<nwalkers, 32, 0, (cudaStream_t)stream>>>(
        partial, (const int4*)chunks, nchunks, feats, nfeat, out);
    return (int)cudaGetLastError();
}
"""
SPLIT_EMPTY = r"""
static __global__ void split_empty() {}
extern "C" int split_empty_launch(int n, void* stream) {
    for (int i = 0; i < n; ++i)
        split_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
"""
_p, _i = ctypes.c_void_p, ctypes.c_int
# family -> (its old source, the split passes appended to it, the grid of
# its case, its old whole call's argument types (its ops/_build.py), its
# data arrays, its partial sums, the ints after (W, nfeat))
FAMILIES = {
    "free": ("lnlike.cu", SPLIT_FREE, "trapz-101",
             [_p, _i, _i, _i] + [_p] * 11 + [_p, _i, _i, _p, _p, _p],
             cl._FREE_ARRAYS, cl.VG_FREE_SLOTS,
             lambda d: (d.nfields,)),
    "fixed": ("lnlike.cu", SPLIT_FIXED, "trapz-201",
              [_p, _i, _i] + [_p] * 3 + [_p, _i, _p, _p, _p],
              cl._FIXED_ARRAYS, cl.VG_HIER_SLOTS, lambda d: ()),
    "z": ("lnlike_z.cu", SPLIT_Z, "trapz-201",
          [_p, _i, _i, _i, _i] + [_p] * 10 + [_p, _i, _p, _p, _p],
          cl._Z_ARRAYS, cl.VG_Z_SLOTS, lambda d: d.shape[1:]),
    "hier": ("lnlike_h.cu", SPLIT_HIER, "trapz-201",
             [_p, _i, _i, _i] + [_p] * 3 + [_p, _i, _p, _p, _p],
             cl._FIXED_ARRAYS, cl.VG_HIER_SLOTS, lambda d: (d.nfields,)),
}
_FINISH_ARGS = [_p, _p, _i, _p, _i, _i, _i, _p, _p]


def build_copy(src_dir, edits, tag, entry):
    """The sources of ``src_dir`` with ``edits`` (file name -> function of
    its text) applied, built into ``_build/`` (keyed on their hash) and
    loaded with the argument types of ``entry``."""
    srcs = sorted(glob.glob(os.path.join(src_dir, "*.cu"))
                  + glob.glob(os.path.join(src_dir, "*.cuh")))
    text = {}
    for s in srcs:
        with open(s) as fh:
            name = os.path.basename(s)
            text[name] = edits.get(name, lambda t: t)(fh.read())
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for name in sorted(text):
        h.update(name.encode() + text[name].encode())
    out_dir = os.path.join(_build.BUILD_DIR, f"{tag}_{h.hexdigest()[:16]}")
    so = os.path.join(out_dir, f"lib{tag}.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        for name, t in text.items():
            with open(os.path.join(out_dir, name), "w") as fh:
                fh.write(t)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
               *sorted(os.path.join(out_dir, n) for n in text
                       if n.endswith(".cu"))]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    for fn, argtypes in entry.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _i
    return lib


def build_old(src_dir):
    """The earlier design's sources with the split entry points of each
    family whose two-pass kernels they hold appended; returns (the
    library, those families)."""
    text = {}
    for name in {f[0] for f in FAMILIES.values()}:
        path = os.path.join(src_dir, name)
        if not os.path.exists(path):
            raise SystemExit(f"{src_dir} holds no {name}")
        with open(path) as fh:
            text[name] = fh.read()
    fams = [f for f, (src, *_) in FAMILIES.items()
            if f"{f}_vg_partials" in text[src]]
    if not fams:
        raise SystemExit(f"{src_dir} holds no two-pass vg kernels")
    add = {"lnlike.cu": SPLIT_EMPTY}
    entry = {"split_empty_launch": [_i, _p]}
    for f in fams:
        src, split, _, whole = FAMILIES[f][:4]
        add[src] = add.get(src, "") + split
        entry[f"{f}_lnlike_vg_launch"] = whole
        entry[f"split_{f}_vg_partials"] = whole[:-2] + [_p]
        entry[f"split_{f}_vg_finish"] = _FINISH_ARGS
    edits = {n: lambda t, a=a: t + a for n, a in add.items()}
    return build_copy(src_dir, edits, "old", entry), fams


# the current kernels with their tail cut short, to split a call's time
# (file -> edit): "no tickets" leaves out the tickets and the finish (each
# block writes its partials and ends), "no finish" draws the tickets (and
# resets them) but leaves out the last block's finish, the last two leave
# out the finish's reads of the partials, or its column pass; the z ones
# leave out the z kernel's node quantities (constants in their place) or its
# grid cells, or let its tiles of 4 take as many registers as they would
_COLS = "for (int c = threadIdx.x; c < nw * ncols; c += THREADS) {"
ABLATIONS = {
    "no tickets": {"vg_ticket.cuh": lambda t: t.replace(
        "    __shared__ int last;\n",
        "    return false;\n    __shared__ int last;\n", 1)},
    "no finish": {"vg_ticket.cuh": lambda t: t.replace(
        "    __syncthreads();\n    return last;\n",
        "    __syncthreads();\n    if (last && threadIdx.x == 0) "
        "tickets[tile] = 0;\n    return false;\n", 1)},
    "finish without partial loads": {"vg_ticket.cuh": lambda t: t.replace(
        "acc[k] += __ldcg(pw + (size_t)p * K + k);", "acc[k] += 1.0;", 1)},
    "finish without columns": {
        n: lambda t: t.replace(_COLS, _COLS.replace("nw * ncols", "1"), 1)
        for n in ("lnlike.cu", "lnlike_h.cu", "lnlike_z.cu")},
    "finish built, never run": {"vg_ticket.cuh": lambda t: t.replace(
        "    __syncthreads();\n    return last;\n",
        "    __syncthreads();\n    if (last && threadIdx.x == 0) "
        "tickets[tile] = 0;\n    return last && nblocks < 0;\n", 1)},
    "z node quantities not formed": {"lnlike_z.cu": lambda t: t.replace(
        "const ZNode z = z_node(\n"
        "                feats + (size_t)(w0 + (j < nw ? j : 0)) * nfeat, dz, "
        "dz2);", "const ZNode z = {dz, 1.0f, dz2, 0.0f};", 1)},
    "z cell loop left out": {"lnlike_z.cu": lambda t: t.replace(
        "for (; r < pc.z; r += phases) {",
        "for (; r < pc.z && r < 0; r += phases) {", 1)},
    "z tiles of 4 unbounded": {"lnlike_z.cu": lambda t: t.replace(
        "__global__ void __launch_bounds__(THREADS, T == 4 ? 3 : 1)\nz_vg(",
        "__global__ void __launch_bounds__(THREADS)\nz_vg(", 1)},
    "finish run twice": {n: lambda t: t.replace(
        "    vg_segment_sums<", "    for (int rep = 0; rep < 2; ++rep) {\n"
        "    vg_segment_sums<", 1).replace(
        "    if (threadIdx.x == 0) tickets[blockIdx.y] = 0;\n",
        "    __syncthreads();\n    }\n"
        "    if (threadIdx.x == 0) tickets[blockIdx.y] = 0;\n", 1)
        for n in ("lnlike.cu", "lnlike_h.cu", "lnlike_z.cu")},
}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def old_calls(lib, fam, data):
    """(whole call, partial pass alone, finish pass alone) of the earlier
    design for ``data``: functions of the features; the passes alone
    share one partial buffer per batch."""
    _, _, _, _, names, k, head = FAMILIES[fam]
    arrays = tuple(getattr(data, a) for a in names)
    head = tuple(head(data))
    nf = data.shape[0] if fam == "z" else data.nfields
    nchunks = data.chunks.shape[0]
    flags = (int(bool(data.fcmin)),) if fam == "free" else ()
    cols = {"free": lambda f: 1 + f.shape[1], "fixed": lambda f: 5,
            "z": lambda f: 8, "hier": lambda f: 2 + 3 * nf}[fam]
    bufs = {}

    def buffers(f):
        w = f.shape[0]
        if w not in bufs:
            bufs[w] = (torch.empty((w, nchunks, k), dtype=torch.float64,
                                   device=f.device),
                       torch.empty((w, cols(f)), dtype=torch.float64,
                                   device=f.device))
        return bufs[w]

    def whole(f):
        w = f.shape[0]
        partial = torch.empty((w, nchunks, k), dtype=torch.float64,
                              device=f.device)
        out = torch.empty((w, cols(f)), dtype=torch.float64, device=f.device)
        _check(getattr(lib, f"{fam}_lnlike_vg_launch")(
            _ptr(f), w, f.shape[1], *head, *(_ptr(a) for a in arrays),
            _ptr(data.chunks), nchunks, *flags, _ptr(partial), _ptr(out),
            _stream()), f"old {fam}_lnlike_vg")
        return out

    def partials(f):
        partial, _ = buffers(f)
        _check(getattr(lib, f"split_{fam}_vg_partials")(
            _ptr(f), f.shape[0], f.shape[1], *head,
            *(_ptr(a) for a in arrays), _ptr(data.chunks), nchunks, *flags,
            _ptr(partial), _stream()), f"old {fam}_vg_partials")
        return partial

    def finish(f):
        partial, out = buffers(f)
        _check(getattr(lib, f"split_{fam}_vg_finish")(
            _ptr(partial), _ptr(data.chunks), nchunks, _ptr(f), f.shape[0],
            f.shape[1], nf, _ptr(out), _stream()), f"old {fam}_vg_finish")
        return out

    return whole, partials, finish


def sweep(case, f, ref):
    """The current kernel at every (walker tile, piece) it is built for
    (the z model's at its rule's row phases and at one phase), each
    checked against the plain version and over two launches, then timed:
    {"tile piece [blocks] (phases)": ms}, the rule's own choice marked by
    ``*``."""
    kernel = getattr(cl, case.kname)
    rule, phase_rule = cl._vg_geometry, cl._z_phases
    npieces = {p: t.shape[0] for p, t, _ in case.data.vg_tables}
    chosen = rule(npieces, f.shape[0], cl._sm_count(f.device.index),
                  cl.VG_TILES[case.fam])
    out = {}
    try:
        for tile in cl.VG_TILES[case.fam]:
            for piece in npieces:
                geom = (tile, piece)
                cl._vg_geometry = lambda *a, g=geom: g
                rule_ph, phases = None, [None]
                if case.fam == "z":
                    rule_ph = phase_rule(case.data.shape[2], cl._z_band_rows(
                        case.data.shape, piece))
                    phases = sorted({rule_ph, 1})
                for ph in phases:
                    if ph is not None:
                        cl._z_phases = lambda *a, g=ph: g
                    got, again = kernel(f, case.data), kernel(f, case.data)
                    torch.cuda.synchronize()
                    err = (cs._rel(got[:, 0], ref[:, 0]),
                           cs._grad_rel(got[:, 1:], ref[:, 1:]))
                    if not (torch.equal(got, again)
                            and err[0] <= cs.RTOL_KERNEL
                            and err[1] <= cs.RTOL_GRAD):
                        raise SystemExit(
                            f"{case.kname} at {geom}, phases {ph}: errors "
                            f"{err}, bit-identical {torch.equal(got, again)}")
                    blocks = -(-f.shape[0] // tile) * npieces[piece]
                    key = (f"{tile} {piece} [{blocks}]"
                           + f" ({ph})" * (ph is not None)
                           + " *" * (geom == chosen and ph == rule_ph))
                    out[key] = cs._device_ms(lambda: kernel(f, case.data))
    finally:
        cl._vg_geometry, cl._z_phases = rule, phase_rule
    print("  sweep (tile piece [blocks] (phases): us): " + ", ".join(
        f"{k}: {v * 1e3:.2f}" for k, v in sorted(out.items(),
                                                 key=lambda kv: kv[1])))
    return out


def ablate(libs, call):
    """``call``'s time with each ablated library in place of the kernel
    library: {ablation: ms}."""
    real = _build.load_library
    out = {}
    try:
        for name, lib in libs.items():
            _build.load_library = lambda lib=lib: lib
            out[name] = cs._device_ms(call)
    finally:
        _build.load_library = real
    print("  ablated (us): " + ", ".join(f"{k}: {v * 1e3:.2f}"
                                         for k, v in out.items()))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="the earlier design's csrc/ directory")
    ap.add_argument("--widths", default="1,8,256")
    ap.add_argument("--families", default="",
                    help="compare only these (comma-separated) of the "
                         "families the old sources hold")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the current kernels with parts of "
                         "their tail left out (ABLATIONS)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the current kernel at every (walker "
                         "tile, piece) it is built for")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cs.phase_device()
    cs.phase_build()
    old, fams = build_old(args.old)
    ablated = {k: build_copy(_build.SRC_DIR, edits, f"ablate{i}",
                             _build.ENTRY_POINTS)
               for i, (k, edits) in enumerate(ABLATIONS.items())
               } if args.ablate else {}
    dev = torch.device("cuda:0")
    widths = [int(x) for x in args.widths.split(",")]

    def empty(n):
        _check(old.split_empty_launch(n, _stream()), "empty kernels")

    res = {"card": cs._SMI[0], "empty_ms": cs._device_ms(lambda: empty(1)),
           "empty_pair_ms": cs._device_ms(lambda: empty(2)), "rows": []}
    print(f"empty kernel {res['empty_ms'] * 1e3:.2f} us, empty pair "
          f"{res['empty_pair_ms'] * 1e3:.2f} us (graph replay)")
    for case in cs._cases(dev, "_vg"):
        if case.fam not in fams or case.grid != FAMILIES[case.fam][2] or (
                args.families and case.fam not in args.families.split(",")):
            continue
        fam, data = case.fam, case.data
        new = getattr(cl, case.kname)
        plain = getattr(cl, case.kname + "_reference")
        whole, partials, finish = old_calls(old, fam, data)
        lo, hi = case.layout.bounds_arrays(torch.float64, dev)
        for w in widths:
            gen = torch.Generator(device=dev).manual_seed(2000 + w)
            th = 0.7 * (lo + hi) / 2 + 0.3 * sample_init(
                gen, case.layout, w, dtype=torch.float64, device=dev)
            f = case.features(th.float()).float()
            got_o, again_o = whole(f), whole(f)
            got_n, again_n = new(f, data), new(f, data)
            ref = plain(f, data)
            torch.cuda.synchronize()
            same = (torch.equal(got_o, again_o), torch.equal(got_n, again_n))
            errs = {}
            for tag, got in (("old", got_o), ("new", got_n)):
                errs[tag] = (cs._rel(got[:, 0], ref[:, 0]),
                             cs._grad_rel(got[:, 1:], ref[:, 1:]))
            errs["new_vs_old"] = (cs._rel(got_n[:, 0], got_o[:, 0]),
                                  cs._grad_rel(got_n[:, 1:], got_o[:, 1:]))
            bad = [t for t, (v, g) in errs.items()
                   if not (v <= cs.RTOL_KERNEL and g <= cs.RTOL_GRAD)]
            if bad or not all(same):
                raise SystemExit(f"{case.kname} W={w}: errors {errs}, "
                                 f"bit-identical (old, new) {same}")
            turns = [cs._device_ms(lambda: whole(f)),
                     cs._device_ms(lambda: new(f, data)),
                     cs._device_ms(lambda: new(f, data)),
                     cs._device_ms(lambda: whole(f))]
            partials(f)
            p_ms = cs._device_ms(lambda: partials(f))
            f_ms = cs._device_ms(lambda: finish(f))
            prof_old = cs._kernel_us(lambda: whole(f))
            prof_new = cs._kernel_us(lambda: new(f, data))
            row = {"kernel": case.kname, "grid": case.grid, "w": w,
                   "cells": int(data.g_a.numel()),
                   "chunks": int(data.chunks.shape[0]),
                   "turns_ms": turns, "old_partials_ms": p_ms,
                   "old_finish_ms": f_ms, "profiler_old_us": prof_old,
                   "profiler_new_us": prof_new, "errors": errs}
            if args.sweep:
                row["sweep"] = sweep(case, f, ref)
            if args.ablate:
                row["ablate_ms"] = ablate(ablated, lambda: new(f, data))
            res["rows"].append(row)
            print(f"{case.kname} {case.grid} W={w}: old / new / new / old "
                  f"{' / '.join(f'{t * 1e3:.2f}' for t in turns)} us; old "
                  f"partials alone {p_ms * 1e3:.2f} us, finish alone "
                  f"{f_ms * 1e3:.2f} us; profiler old "
                  f"{ {k: round(v, 2) for k, v in prof_old.items()} }, new "
                  f"{ {k: round(v, 2) for k, v in prof_new.items()} }; "
                  f"vs plain value/gradient old {errs['old'][0]:.2e} / "
                  f"{errs['old'][1]:.2e}, new {errs['new'][0]:.2e} / "
                  f"{errs['new'][1]:.2e}; both bit-identical over two "
                  "launches")
    print(cs._SMI[0])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "vg_turns.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({"rows": len(res["rows"]),
                      "median_ratio_new_over_old": float(np.median(
                          [(r["turns_ms"][1] + r["turns_ms"][2])
                           / (r["turns_ms"][0] + r["turns_ms"][3])
                           for r in res["rows"]]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
