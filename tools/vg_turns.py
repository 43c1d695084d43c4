"""The one-launch kernels against an earlier design of the same kernels,
in turns on one card: the NUTS paths' value+gradient kernels
(``free_lnlike_vg`` of ``fit --sampler nuts``, ``fixed_lnlike_vg`` of
``fit -fc --sampler nuts``, ``z_lnlike_vg`` of ``fitz --sampler nuts``,
``hier_lnlike_vg`` of ``fith --sampler nuts``), or with ``--value`` the
stretch paths' value kernels (``z_lnlike`` of ``fitz``, ``hier_lnlike`` of
``fith``).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/vg_turns.py --old DIR [--value] [--widths 1,8,256]
                              [--families F,..] [--sweep] [--ablate]

``DIR`` holds the earlier design's ``csrc/`` (for instance a ``git
archive`` of an earlier commit unpacked under ``_archive/``, which
``.gitignore`` lists), built into a library of its own under
``lumfuncmcmc_tpu_torch/_build/`` with a pair of empty kernels appended.
Each kernel is compared (or those of ``--families``): where ``DIR`` holds
its two-pass design (``*_vg_partials`` and ``*_vg_finish``; ``z_partials``
or ``hier_partials`` and the shared ``finish`` for the value kernels), C
entry points appended to the copies run each pass alone; else ``DIR`` is
an earlier build of the one-launch kernel, whose C entry point is the
current one (for instance the parent commit's ``csrc/``), and the current
wrapper runs it through that library. On the fits' own catalog (``fit
--synthetic 2000``'s: ``free_lnlike_vg`` at trapz-101, the others at
trapz-201) and at each walker batch (default 1, 8, 256; with ``--value``
13, 50, 100, 2400) it checks the old call and the current wrapper against
the plain version and each other (values rtol 1e-4, gradients 2e-3 by
``_grad_close``; whether the two give the same bits is reported) and two
launches of each on one input bit for bit; then times, in
``chip_smoke.py``'s ``_device_ms`` harness (a CUDA graph of 20 calls
replayed between CUDA events): the old call and the current one in turns
(old, new, new, old), a two-pass design's partial and finish passes alone,
one and two empty kernels; and, under ``torch.profiler``, each kernel's own
device time per call. With ``--sweep`` it also times the current kernels
at every (walker tile, piece) they are built for (the z model's at its
rule's row phases and at one), and with ``--ablate`` builds of them with
parts left out (``ABLATIONS``). Prints one line per measurement, the
card's name and power limit, and writes the JSON summary to
``chiprun_out/vg_turns.json``. Imports only the port.
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
from typing import Callable, NamedTuple, Optional

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
extern "C" int split_free_lnlike_vg_partials(
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
extern "C" int split_free_lnlike_vg_finish(
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
extern "C" int split_hier_lnlike_vg_partials(
        const float* feats, int nwalkers, int nfeat, int nfields,
        const float* g_a, const float* g_p, const float* g_w,
        const int* chunks, int nchunks, double* partial, void* stream) {
    hier_vg_partials<<<dim3(nchunks, nwalkers), THREADS, 0,
                       (cudaStream_t)stream>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    return (int)cudaGetLastError();
}
extern "C" int split_hier_lnlike_vg_finish(
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
extern "C" int split_fixed_lnlike_vg_partials(
        const float* feats, int nwalkers, int nfeat, const float* g_a,
        const float* g_p, const float* g_w, const int* chunks, int nchunks,
        double* partial, void* stream) {
    fixed_vg_partials<<<dim3(nchunks, nwalkers), THREADS, 0,
                        (cudaStream_t)stream>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    return (int)cudaGetLastError();
}
extern "C" int split_fixed_lnlike_vg_finish(
        const double* partial, const int* chunks, int nchunks,
        const float* feats, int nwalkers, int nfeat, int nfields,
        double* out, void* stream) {
    fixed_vg_finish<<<nwalkers, 32, 0, (cudaStream_t)stream>>>(
        partial, nchunks, feats, nfeat, out);
    return (int)cudaGetLastError();
}
"""
SPLIT_Z = r"""
extern "C" int split_z_lnlike_vg_partials(
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
extern "C" int split_z_lnlike_vg_finish(
        const double* partial, const int* chunks, int nchunks,
        const float* feats, int nwalkers, int nfeat, int nfields,
        double* out, void* stream) {
    z_vg_finish<<<nwalkers, 32, 0, (cudaStream_t)stream>>>(
        partial, (const int4*)chunks, nchunks, feats, nfeat, out);
    return (int)cudaGetLastError();
}
"""
# the value kernels' finish, common.cuh's, at every finish's C signature
SPLIT_VALUE_FINISH = r"""
extern "C" int split_FAM_lnlike_finish(
        const double* partial, const int* chunks, int nchunks,
        const float* feats, int nwalkers, int nfeat, int nfields,
        double* out, void* stream) {
    finish<<<(nwalkers + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        partial, nchunks, nwalkers, out);
    return (int)cudaGetLastError();
}
"""
SPLIT_Z_VALUE = r"""
extern "C" int split_z_lnlike_partials(
        const float* feats, int nwalkers, int nfeat, int s_l, int s_z,
        const float* g_a, const float* g_p, const float* g_w,
        const float* n_dz, const float* n_dz2, const float* s_a,
        const float* s_dz, const float* s_dz2, const float* s_lnom0,
        const float* s_mask, const int* chunks, int nchunks,
        double* partial, void* stream) {
    z_partials<<<dim3(nchunks, nwalkers), THREADS, 0,
                 (cudaStream_t)stream>>>(
        feats, nfeat, s_l, s_z, g_a, g_p, g_w, n_dz, n_dz2, s_a, s_dz, s_dz2,
        s_lnom0, s_mask, (const int4*)chunks, nchunks, partial);
    return (int)cudaGetLastError();
}
""" + SPLIT_VALUE_FINISH.replace("FAM", "z")
SPLIT_HIER_VALUE = r"""
extern "C" int split_hier_lnlike_partials(
        const float* feats, int nwalkers, int nfeat, int nfields,
        const float* g_a, const float* g_p, const float* g_w,
        const int* chunks, int nchunks, double* partial, void* stream) {
    hier_partials<<<dim3(nchunks, nwalkers), THREADS, 0,
                    (cudaStream_t)stream>>>(
        feats, nfeat, g_a, g_p, g_w, (const int4*)chunks, nchunks, partial);
    return (int)cudaGetLastError();
}
""" + SPLIT_VALUE_FINISH.replace("FAM", "hier")
SPLIT_EMPTY = r"""
static __global__ void split_empty() {}
extern "C" int split_empty_launch(int n, void* stream) {
    for (int i = 0; i < n; ++i)
        split_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
"""
_p, _i = ctypes.c_void_p, ctypes.c_int
_FREE_OLD = [_p, _i, _i, _i] + [_p] * 11 + [_p, _i, _i, _p, _p, _p]
_FIXED_OLD = [_p, _i, _i] + [_p] * 3 + [_p, _i, _p, _p, _p]
_Z_OLD = [_p, _i, _i, _i, _i] + [_p] * 10 + [_p, _i, _p, _p, _p]
_HIER_OLD = [_p, _i, _i, _i] + [_p] * 3 + [_p, _i, _p, _p, _p]
_FINISH_ARGS = [_p, _p, _i, _p, _i, _i, _i, _p, _p]


class Family(NamedTuple):
    """A kernel's two-pass design: its source, the split passes appended to
    it, the grid of its case, its whole call's argument types (that
    design's ops/_build.py), its data arrays, its partial sums a (walker,
    chunk), the ints after (W, nfeat), the definition of its partial pass
    (present only in that design), and its output columns given the data
    and the features (None: a value)."""
    src: str
    split: str
    grid: str
    whole: list
    arrays: tuple
    slots: int
    head: Callable
    mark: str
    cols: Optional[Callable]


FAMILIES = {
    "free_lnlike_vg": Family(
        "lnlike.cu", SPLIT_FREE, "trapz-101", _FREE_OLD, cl._FREE_ARRAYS,
        cl.VG_FREE_SLOTS, lambda d: (d.nfields,), "free_vg_partials(",
        lambda d, f: 1 + f.shape[1]),
    "fixed_lnlike_vg": Family(
        "lnlike.cu", SPLIT_FIXED, "trapz-201", _FIXED_OLD, cl._FIXED_ARRAYS,
        cl.VG_HIER_SLOTS, lambda d: (), "fixed_vg_partials(",
        lambda d, f: 5),
    "z_lnlike_vg": Family(
        "lnlike_z.cu", SPLIT_Z, "trapz-201", _Z_OLD, cl._Z_ARRAYS,
        cl.VG_Z_SLOTS, lambda d: d.shape[1:], "z_vg_partials(",
        lambda d, f: 8),
    "hier_lnlike_vg": Family(
        "lnlike_h.cu", SPLIT_HIER, "trapz-201", _HIER_OLD, cl._FIXED_ARRAYS,
        cl.VG_HIER_SLOTS, lambda d: (d.nfields,), "hier_vg_partials(",
        lambda d, f: 2 + 3 * d.nfields),
    "z_lnlike": Family(
        "lnlike_z.cu", SPLIT_Z_VALUE, "trapz-201", _Z_OLD, cl._Z_ARRAYS, 1,
        lambda d: d.shape[1:], "\nz_partials(", None),
    "hier_lnlike": Family(
        "lnlike_h.cu", SPLIT_HIER_VALUE, "trapz-201", _HIER_OLD,
        cl._FIXED_ARRAYS, 1, lambda d: (d.nfields,), "\nhier_partials(",
        None),
}


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


def build_old(src_dir, knames):
    """The earlier sources with a pair of empty kernels and the split
    entry points of each kernel of ``knames`` whose two-pass design they
    hold appended; returns (the library, {kernel: whether the sources hold
    its two-pass design, else an earlier build of its one-launch
    design})."""
    text = {}
    for name in {FAMILIES[k].src for k in knames} | {"lnlike.cu"}:
        path = os.path.join(src_dir, name)
        if not os.path.exists(path):
            raise SystemExit(f"{src_dir} holds no {name}")
        with open(path) as fh:
            text[name] = fh.read()
    add = {"lnlike.cu": SPLIT_EMPTY}
    entry = {"split_empty_launch": [_i, _p]}
    kinds = {}
    for k in knames:
        fm = FAMILIES[k]
        kinds[k] = fm.mark in text[fm.src]
        if kinds[k]:
            add[fm.src] = add.get(fm.src, "") + fm.split
            entry[f"{k}_launch"] = fm.whole
            entry[f"split_{k}_partials"] = fm.whole[:-2] + [_p]
            entry[f"split_{k}_finish"] = _FINISH_ARGS
        else:
            entry[f"{k}_launch"] = _build.ENTRY_POINTS[f"{k}_launch"]
    edits = {n: lambda t, a=a: t + a for n, a in add.items()}
    return build_copy(src_dir, edits, "old", entry), kinds


# the current kernels with their tail cut short, to split a call's time
# (file -> edit): "no tickets" leaves out the tickets and the finish (each
# block writes its partials and ends), "no finish" draws the tickets (and
# resets them) but leaves out the last block's finish, the next two leave
# out the finish's reads of the partials, or its column pass (z_lnlike's:
# its rows); the z ones leave out the z kernels' node quantities (constants
# in their place) or their grid cells, or let z_lnlike_vg's tiles of 4 take
# as many registers as they would
_COLS = "for (int c = threadIdx.x; c < nw * ncols; c += THREADS) {"
_ROWS = "for (int j = threadIdx.x; j < nw; j += THREADS) {"
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
        n: lambda t: t.replace(_COLS, _COLS.replace("nw * ncols", "1")
                               ).replace(_ROWS, _ROWS.replace("< nw", "< 1"))
        for n in ("lnlike.cu", "lnlike_h.cu", "lnlike_z.cu")},
    "finish built, never run": {"vg_ticket.cuh": lambda t: t.replace(
        "    __syncthreads();\n    return last;\n",
        "    __syncthreads();\n    if (last && threadIdx.x == 0) "
        "tickets[tile] = 0;\n    return last && nblocks < 0;\n", 1)},
    "z node quantities not formed": {"lnlike_z.cu": lambda t: t.replace(
        "const ZNode z = z_node(\n"
        "                feats + (size_t)(w0 + (j < nw ? j : 0)) * nfeat, dz, "
        "dz2);", "const ZNode z = {dz, 1.0f, dz2, 0.0f};")},
    "z cell loop left out": {"lnlike_z.cu": lambda t: t.replace(
        "for (; r < pc.z; r += phases) {",
        "for (; r < pc.z && r < 0; r += phases) {")},
    "z tiles of 4 unbounded": {"lnlike_z.cu": lambda t: t.replace(
        "__global__ void __launch_bounds__(THREADS, T == 4 ? 3 : 1)\nz_vg(",
        "__global__ void __launch_bounds__(THREADS)\nz_vg(", 1)},
    "finish run twice": {n: lambda t: t.replace(
        "    vg_segment_sums<", "    for (int rep = 0; rep < 2; ++rep) {\n"
        "    vg_segment_sums<").replace(
        "    if (threadIdx.x == 0) tickets[blockIdx.y] = 0;\n",
        "    __syncthreads();\n    }\n"
        "    if (threadIdx.x == 0) tickets[blockIdx.y] = 0;\n")
        for n in ("lnlike.cu", "lnlike_h.cu", "lnlike_z.cu")},
}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def z_chunk_table(shape, nsrc):
    """Bands of L rows holding about ``CHUNK_CELLS`` cells for every field,
    then the sources in pieces of at most ``CHUNK_CELLS``: the launch table
    of the z model's two-pass kernels, which its data no longer keeps."""
    nf, sl, sz = shape
    band = max(1, cl.CHUNK_CELLS // sz)
    rows = [(f, r, min(r + band, sl), 0)
            for f in range(nf) for r in range(0, sl, band)]
    rows += [(0, s, min(s + cl.CHUNK_CELLS, nsrc), 1)
             for s in range(0, nsrc, cl.CHUNK_CELLS)]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 4)


def old_calls(lib, kname, data, two_pass):
    """(whole call, partial pass alone, finish pass alone, chunks) of the
    earlier design of kernel ``kname`` for ``data``: functions of the
    features; the passes alone share one partial buffer per batch. An
    earlier build of the one-launch kernel (not ``two_pass``) runs through
    the current wrapper and has no passes: (whole call, None, None, 0)."""
    if not two_pass:
        kernel = getattr(cl, kname)

        def through_old(f):
            real = _build.load_library
            _build.load_library = lambda: lib
            try:
                return kernel(f, data)
            finally:
                _build.load_library = real
        return through_old, None, None, 0
    fm = FAMILIES[kname]
    arrays = tuple(getattr(data, a) for a in fm.arrays)
    head = tuple(fm.head(data))
    z = isinstance(data, cl.CudaZData)
    nf = data.shape[0] if z else data.nfields
    chunks = (torch.as_tensor(z_chunk_table(data.shape, data.s_a.numel()),
                              device=data.g_a.device) if z else data.chunks)
    nchunks = chunks.shape[0]
    flags = (int(bool(data.fcmin)),) if kname.startswith("free") else ()

    def empty(f):
        w = f.shape[0]
        return (torch.empty((w, nchunks, fm.slots), dtype=torch.float64,
                            device=f.device),
                torch.empty((w,) if fm.cols is None else
                            (w, fm.cols(data, f)), dtype=torch.float64,
                            device=f.device))

    bufs = {}

    def buffers(f):
        if f.shape[0] not in bufs:
            bufs[f.shape[0]] = empty(f)
        return bufs[f.shape[0]]

    def whole(f):
        partial, out = empty(f)
        _check(getattr(lib, f"{kname}_launch")(
            _ptr(f), f.shape[0], f.shape[1], *head,
            *(_ptr(a) for a in arrays), _ptr(chunks), nchunks, *flags,
            _ptr(partial), _ptr(out), _stream()), f"old {kname}")
        return out

    def partials(f):
        partial, _ = buffers(f)
        _check(getattr(lib, f"split_{kname}_partials")(
            _ptr(f), f.shape[0], f.shape[1], *head,
            *(_ptr(a) for a in arrays), _ptr(chunks), nchunks, *flags,
            _ptr(partial), _stream()), f"old {kname} partials")
        return partial

    def finish(f):
        partial, out = buffers(f)
        _check(getattr(lib, f"split_{kname}_finish")(
            _ptr(partial), _ptr(chunks), nchunks, _ptr(f), f.shape[0],
            f.shape[1], nf, _ptr(out), _stream()), f"old {kname} finish")
        return out

    return whole, partials, finish, nchunks


def _errs(got, ref):
    """(value, gradient) errors of ``got`` against ``ref``: the rows of a
    value+gradient kernel, or a value kernel's values (gradient 0)."""
    if got.dim() == 1:
        return cs._rel(got, ref), 0.0
    return (cs._rel(got[:, 0], ref[:, 0]),
            cs._grad_rel(got[:, 1:], ref[:, 1:]))


def sweep(case, f, ref):
    """The current kernel at every (walker tile, piece) it is built for
    (the z model's at its rule's row phases and at one phase), each
    checked against the plain version and over two launches, then timed:
    {"tile piece [blocks] (phases)": ms}, the rule's own choice marked by
    ``*``."""
    kernel = getattr(cl, case.kname)
    rule, phase_rule = cl._vg_geometry, cl._z_phases
    npieces = {p: t.shape[0] for p, t, _ in case.data.vg_tables}
    tiles = cl._tiles(case.kname)
    chosen = rule(npieces, f.shape[0], cl._sm_count(f.device.index), tiles)
    out = {}
    try:
        for tile in tiles:
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
                    err = _errs(got, ref)
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


def design_turns(args):
    """The current kernels against the earlier design of ``args.old`` (the
    value+gradient kernels, or with ``args.value`` the value kernels), in
    turns: the JSON summary."""
    suffix = "" if args.value else "_vg"
    knames = [k for k in FAMILIES if k.endswith("_lnlike" + suffix) and (
        not args.families or k.split("_")[0] in args.families.split(","))]
    old, kinds = build_old(args.old, knames)
    ablated = {k: build_copy(_build.SRC_DIR, edits, f"ablate{i}",
                             _build.ENTRY_POINTS)
               for i, (k, edits) in enumerate(ABLATIONS.items())
               } if args.ablate else {}
    dev = torch.device("cuda:0")
    widths = [int(x) for x in (args.widths or (
        "13,50,100,2400" if args.value else "1,8,256")).split(",")]

    def empty(n):
        _check(old.split_empty_launch(n, _stream()), "empty kernels")

    res = {"card": cs._SMI[0], "mode": "value" if args.value else "vg",
           "empty_ms": cs._device_ms(lambda: empty(1)),
           "empty_pair_ms": cs._device_ms(lambda: empty(2)), "rows": []}
    print(f"empty kernel {res['empty_ms'] * 1e3:.2f} us, empty pair "
          f"{res['empty_pair_ms'] * 1e3:.2f} us (graph replay)")
    for case in cs._cases(dev, suffix):
        if case.kname not in kinds or case.grid != FAMILIES[case.kname].grid:
            continue
        data, two_pass = case.data, kinds[case.kname]
        new = getattr(cl, case.kname)
        plain = getattr(cl, case.kname + "_reference")
        whole, partials, finish, nchunks = old_calls(old, case.kname, data,
                                                     two_pass)
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
            errs = {"old": _errs(got_o, ref), "new": _errs(got_n, ref),
                    "new_vs_old": _errs(got_n, got_o)}
            bad = [t for t, (v, g) in errs.items()
                   if not (v <= cs.RTOL_KERNEL and g <= cs.RTOL_GRAD)]
            if bad or not all(same) or data.vg_tickets.any():
                raise SystemExit(f"{case.kname} W={w}: errors {errs}, "
                                 f"bit-identical (old, new) {same}, "
                                 f"tickets at 0 "
                                 f"{not data.vg_tickets.any()}")
            turns = [cs._device_ms(lambda: whole(f)),
                     cs._device_ms(lambda: new(f, data)),
                     cs._device_ms(lambda: new(f, data)),
                     cs._device_ms(lambda: whole(f))]
            row = {"kernel": case.kname, "grid": case.grid, "w": w,
                   "cells": int(data.g_a.numel()), "two_pass": two_pass,
                   "chunks": int(nchunks), "turns_ms": turns,
                   "same_bits": torch.equal(got_n, got_o),
                   "profiler_old_us": cs._kernel_us(lambda: whole(f)),
                   "profiler_new_us": cs._kernel_us(lambda: new(f, data)),
                   "errors": errs}
            split = ""
            if two_pass:
                partials(f)
                row["old_partials_ms"] = cs._device_ms(lambda: partials(f))
                row["old_finish_ms"] = cs._device_ms(lambda: finish(f))
                split = (f"; old partials alone "
                         f"{row['old_partials_ms'] * 1e3:.2f} us, finish "
                         f"alone {row['old_finish_ms'] * 1e3:.2f} us")
            if args.sweep:
                row["sweep"] = sweep(case, f, ref)
            if args.ablate:
                row["ablate_ms"] = ablate(ablated, lambda: new(f, data))
            res["rows"].append(row)
            prof = {k: {n: round(v, 2) for n, v in row[k].items()}
                    for k in ("profiler_old_us", "profiler_new_us")}
            print(f"{case.kname} {case.grid} W={w}: old / new / new / old "
                  f"{' / '.join(f'{t * 1e3:.2f}' for t in turns)} us{split}; "
                  f"profiler old {prof['profiler_old_us']}, new "
                  f"{prof['profiler_new_us']}; vs plain value/gradient old "
                  f"{errs['old'][0]:.2e} / {errs['old'][1]:.2e}, new "
                  f"{errs['new'][0]:.2e} / {errs['new'][1]:.2e}; old and new "
                  f"{'the same' if row['same_bits'] else 'different'} bits; "
                  "both bit-identical over two launches, tickets at 0")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="the earlier design's csrc/ directory")
    ap.add_argument("--value", action="store_true",
                    help="compare the value kernels z_lnlike and "
                         "hier_lnlike (else the value+gradient kernels)")
    ap.add_argument("--widths", default="",
                    help="walker batches (default 1,8,256; with --value "
                         "13,50,100,2400)")
    ap.add_argument("--families", default="",
                    help="compare only these (comma-separated) "
                         "families")
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
    res = design_turns(args)
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
