"""Hand-written CUDA kernels for the single-epoch, the
redshift-evolving and the hierarchical log-likelihood (counterpart of
``lumfuncmcmc_tpu/ops/pallas_lnlike.py``).

Per walker theta the kernels evaluate

    lnL = sum_n [ ln phi(L_n) + ln Omega(L_n, z_n | theta) ]
          - sum_{f,i,j} phi(logL[f,i,j]) * Omega(logf[f,i,j] | theta) * w[f,i,j]

in the factored form of the TPU kernels: the theta-independent
exponentials are precomputed on the host, ``P = 10^(logL - lref)`` and
``R = 10^(logf + 16)``, so the Schechter cutoff and the Fleming decay
ratio become multiplies by per-walker scalars. Theta enters as a
per-walker feature row (:func:`_features`).
Unlike the TPU kernels, luminosities enter relative to ``lref``
(``a = LN10 (logL - lref)``, feature ``lA = LN10 (Lstar - lref)``) and
the fixed-completeness collapsed ln-term is computed in float64: in
float32, ``a - lA`` of two ~97-sized numbers and ``sum(lum) - N Lstar``
cancel to ~1e-5 relative, which the theta-gradient of ``sch_al`` feels
where its two parts cancel near the mode.

Every kernel returns float64 values, and the collapsed ln-terms
(fixed completeness's ``lnpart``, the hierarchical ``lnrest``, the
streaming kernels' affine source terms) are added on the host in float64
from the same rounded features the kernel reads (:func:`_round_st`): at
10^5 sources |lnL| ~ 1e6, where a float32 value or a float32 feature
carrying a ~1e6-sized term cannot resolve the 0.05 that the sampler's
accept step bears in the lnp difference of two close thetas
(``tests/test_torch_precision.py``). A run that is not float64 is
refused from ``FLOAT32_MAX_SOURCES`` sources on
(``models/model.py _check_precision``).

Four single-epoch kernels, value and value + gradient, each pair one
kernel body (free completeness in ``csrc/lnlike.cu``, fixed completeness
in ``csrc/lnlike_h.cu``, the hierarchical kernels' body with the features
shared by every field):

- :func:`free_lnlike` — free completeness; replaces both
  ``_kernel_free_bcast`` (``pallas_lnlike.py:601``) and ``_kernel_free``
  (``:761``);
- :func:`fixed_lnlike` — fixed completeness; replaces both
  ``_kernel_fixed_bcast`` (``:751``) and ``_kernel_fixed`` (``:813``);
- :func:`free_lnlike_vg` — free completeness, the lnlike and its
  derivative with respect to every feature in one pass;
  replaces ``_kernel_free_vg`` (``:832``);
- :func:`fixed_lnlike_vg` — the same for fixed completeness; replaces
  ``_kernel_fixed_vg`` (``:1255``).

Two kernels of ``csrc/lnlike_z.cu`` for the redshift-evolving model
(fixed completeness; (L*, phi*)(z) quadratic in z, :func:`_feat_z_one`):

- :func:`z_lnlike` replaces both ``_kernel_z_bcast`` (``:659``) and
  ``_kernel_z2_slab`` (``:677``), in the latter's factoring: the
  quadratics and the cutoff scale ``t1(z)`` are formed once per z node
  and band of L rows, so a cell costs one exp; one launch a call;
- :func:`z_lnlike_vg` replaces ``_kernel_z_vg`` (``:1142``): the lnlike
  and its derivative with respect to the 7 features from three column
  sums per z node.

Their features differ from the TPU's where float32 demands it: the
quadratics are in ``dz = z - z2`` (the central pivot) and luminosities
relative to ``lref``, with the pivot algebra done in float64, so no
term is much larger than its result (the TPU form adds ~240-sized
terms to a ~98-sized ``LN10 Lstar(z)`` and subtracts that from a
~98-sized ``LN10 logL``). The function computed is the same.

Two kernels of ``csrc/lnlike_h.cu`` for the hierarchical multi-field
model (fixed completeness; per-field (L*, phi*), :func:`_feat_h_one`):

- :func:`hier_lnlike` replaces both ``_kernel_hier_bcast`` (``:713``)
  and ``_kernel_hier_slab`` (``:734``): the fixed-completeness kernel
  whose blocks read ``(c_f, lA_f, t1_f)`` of their piece's own field, in
  one launch (the kernel body of :func:`hier_lnlike_vg`, one sum a
  walker);
- :func:`hier_lnlike_vg` replaces ``_kernel_hier_vg`` (``:1221``): the
  lnlike and its derivative with respect to the 1+3F features from
  three sums per field, in one launch.

Their features keep the TPU's order without its ``lnrest``, ``[aA,
(c_f, lA_f, t1_f) x F]``; as in the fixed-completeness family,
luminosities are relative to ``lref``, and ``lnrest`` (the per-field
collapsed ln-terms plus the Gaussian hyperprior) is formed on the host in
float64 from per-field catalog sums taken relative to ``lref``
(:func:`_hier_collapsed`).

Two kernels of ``csrc/lnlike_stream.cu`` for free completeness on mega
catalogs (at least ``STREAM_MIN_SOURCES`` sources, where
:func:`_make_lnprob` takes them):

- :func:`free_stream_lnlike` replaces ``_kernel_free_stream``
  (``:941``, and ``make_stream_shard_batched``, ``:404``): a block
  stages a run of one field's source tiles in shared memory by bulk
  asynchronous copy and runs every walker of its group against it;
- :func:`free_stream_lnlike_vg` replaces ``_kernel_free_stream_vg``
  (``:1009``, and ``make_stream_shard_vg``, ``:1711``).

Their layout (:func:`prepare_cuda_stream_data`) is per shard, the
contract of ``prepare_stream_shard_data`` (``:346``): grid weights over
``nshards``, each field's sources dealt round-robin to the shards and
padded to whole tiles at offsets shared by all shards, and the kernels'
run table over those tiles, cut for one wave of the card
(:func:`_run_pieces`). At 10^6 sources
|lnL| ~ 1.5e7, so float32 alone cannot resolve the accept step's lnp
differences; three changes from the TPU form keep them to ~0.02
(``tests/test_torch_stream.py``): the kernels sum and return the value in
float64, the theta-affine source terms are collapsed in float64 from
per-shard catalog sums (:func:`_stream_collapsed`, added on the host),
and ``logf``/``lF50`` enter relative to ``_LOGF_REF``.

The value+gradient kernels feed :func:`make_cuda_lnprob_and_grad`, the
NUTS gradient path: a ``torch.autograd.Function`` hands the feature
gradient to autograd of the cheap feature map, the counterpart of the
``jax.custom_vjp`` of ``_vg_scalar_from_rows`` (``:1614``).

The TPU's broadcast/slab split exists only because of VMEM and does not
carry over: one packing serves every catalog size. Cells and sources are
concatenated field by field (no lane padding) with ``(F+1,)`` field
offsets. Every kernel of the resident layout is one launch a call: a
(piece, walker tile) grid over piece tables of several lengths
(:func:`_vg_tables`; bands of L rows for the z model,
:func:`_z_vg_tables`), one chosen per call from the batch and the card
(:func:`_vg_geometry`); the last block of each walker tile to draw its
ticket (``vg_tickets``, zeroed once) writes the tile's rows.

Dispatch rule: a CPU tensor takes the plain PyTorch version
(:func:`free_lnlike_reference`, :func:`fixed_lnlike_reference`,
:func:`z_lnlike_reference`, :func:`hier_lnlike_reference` and their
``_vg`` twins), a CUDA tensor
launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.cosmology import SQARCSEC_PER_SR
from lumfuncmcmc_tpu_torch.models.context import LFContext
from lumfuncmcmc_tpu_torch.models.hierarchical import (
    ThetaLayoutH, _ln_normal)
from lumfuncmcmc_tpu_torch.models.likelihood import (
    ThetaLayout, in_box)
from lumfuncmcmc_tpu_torch.models.likelihood_z import (
    ThetaLayoutZ, in_box_z)
from lumfuncmcmc_tpu_torch.ops.completeness import (
    _log10_inverse_fleming_ratio)
from lumfuncmcmc_tpu_torch.ops.schechter import LN10

_LOG_LN10 = math.log(LN10)
_LOGF_REF = -16.0       # reference log10-flux for the R factorization
CHUNK_CELLS = 2048      # sources of a streaming tile (lnlike_stream.cu)
MAX_ROWS = 65535        # walkers one launch takes (grid.y limit)
VG_FREE_SLOTS = 7       # partial sums per (walker, piece), csrc/lnlike.cu
VG_Z_SLOTS = 8          # csrc/lnlike_z.cu
VG_HIER_SLOTS = 3       # csrc/lnlike_h.cu (hier_lnlike_vg, fixed_lnlike_vg)
MAX_HIER_FIELDS = 64    # csrc/lnlike_h.cu
THREADS = 256           # csrc/common.cuh: threads of a block
X_CLAMP = 60.0          # z_lnlike_vg clamps a source's x = a - lq here
# free completeness takes the streaming kernels from this many sources on,
# for the accept step's sake and not for speed: the one-launch resident
# free_lnlike is the faster kernel where the two were measured (at W = 50
# on the 1,019,385-source catalog 101.72 us against free_stream_lnlike's
# 151.55 us, H100 80GB HBM3 at 700 W), but its float32 features round c_s
# apart from c_g, which costs it 0.022 in the lnp differences of close
# thetas at 4.2e4 sources, 0.046 at 1.7e5 and 0.47 at 1.0e6, against
# 0.001-0.011 for the streaming route and the 0.05 that the accept step
# bears (PERF.md, tools/stream_crossover.py, chip_smoke.py phase_stream)
STREAM_MIN_SOURCES = 40_000
# a run that is not float64 is refused from this many sources on: its lnp,
# cast to float32 at |lnL| ~ 15 N, then errs by up to one float32 spacing
# (2^-4 from |lnL| = 2^19), past the 0.05 that the lnp difference of close
# thetas can bear; every family crosses 0.05 between 30,574 and 34,013
# sources (PERF.md; tools/stream_crossover.py --emulate)
FLOAT32_MAX_SOURCES = 30_000
VG_STREAM_SLOTS = 6     # partial sums per (walker, run), lnlike_stream.cu
STREAM_MAX_RUN = 4      # source tiles one streaming block stages at once
# the one-launch kernels (the value and value+gradient kernels of
# csrc/lnlike.cu, csrc/lnlike_h.cu and csrc/lnlike_z.cu; _vg_geometry):
# their piece lengths in cells, longest first
# (the z model's bands hold about as many cells: _z_vg_tables), and the
# walker tiles each is built for, by family for the value+gradient kernels
# and family + "_value" for the value kernels (_tiles), in the order
# _vg_geometry prefers them at equal work a block (each kernel's own sweep:
# PERF.md; larger tiles held too many registers on an H100 and ran slower)
VG_PIECES = (4096, 2048, 1024, 512)
VG_Z_PIECES = (16384, 8192, 4096, 2048, 1024)
VG_TILES = {"free": (1, 2), "fixed": (4, 2, 1), "z": (2, 4, 1),
            "hier": (1, 2, 4), "free_value": (1, 4, 2),
            "fixed_value": (4, 8, 2, 1), "z_value": (2, 8, 4, 1),
            "hier_value": (4, 8, 2, 1)}


def _clamp_flim(theta, layout: ThetaLayout):
    """Keep theta's Flim block positive for the ``log10`` in the feature
    map; out-of-box thetas are masked by the caller."""
    if layout.fix_comp:
        return theta
    nf = layout.nfields
    k = 2 if layout.fix_sch_al else 3
    flim = torch.clamp(theta[:, k:k + nf], min=1e-6)
    return torch.cat([theta[:, :k], flim, theta[:, k + nf:]], dim=1)


# ---------------------------------------------------------------------------
# data preparation (host side, once per context)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CudaGridData:
    """Per-field concatenated cell and source arrays for the kernels.

    Grid arrays are (C,), source arrays (N,), fields back to back;
    ``grid_off``/``src_off`` hold the (F+1,) field offsets on the host
    (for the plain versions). Fixed completeness keeps only ``g_a``,
    ``g_p`` and ``g_w``. ``vg_tables`` and ``vg_tickets`` are the launch
    tables and tickets of every kernel of the family (``free_lnlike(_vg)``,
    ``fixed_lnlike(_vg)``, ``hier_lnlike(_vg)``; :func:`_vg_tables`).
    """

    g_a: torch.Tensor                  # LN10 * (logL - lref)
    g_p: torch.Tensor                  # 10^(logL - lref)
    g_w: torch.Tensor                  # quadrature weight * area * ln10
    g_logf: Optional[torch.Tensor]     # log10 flux of grid cells
    g_r: Optional[torch.Tensor]        # 10^(logf - logf_ref)
    s_logf: Optional[torch.Tensor]
    s_a: Optional[torch.Tensor]
    s_p: Optional[torch.Tensor]
    s_r: Optional[torch.Tensor]
    s_lnom0: Optional[torch.Tensor]    # ln(Omega0_src / sqarcsec)
    s_mask: Optional[torch.Tensor]
    grid_off: tuple
    src_off: tuple
    lref: float
    nfields: int
    fcmin: float                       # 0 disables the faint-end term
    ln_sums: tuple                     # float64 (nsrc, sum(lum - lref),
                                       #   sum_pow_lum, sum_ln_om) of the
                                       #   collapsed ln-term
    # --- the kernels' launch tables (_vg_tables), and their arrival
    # tickets, zeroed here once and left at 0 by every launch ---
    vg_tables: tuple = ()
    vg_tickets: Optional[torch.Tensor] = None  # (MAX_ROWS,) int32
    # --- the hierarchical model only (prepare_cuda_h_data) ---
    ln_sums_f: Optional[torch.Tensor] = None   # (4, F) float64: the same
                                               #   four sums per field
    lo: Optional[torch.Tensor] = None          # the prior box in float64,
    hi: Optional[torch.Tensor] = None          #   for the features' clamp


def _grid_cols(ctx: LFContext, fix_comp: bool, lref: float):
    """Per-field grid feature dicts (float64 numpy). Free completeness
    folds the per-field area fraction and the ln10 Schechter prefactor
    into the weights; fixed completeness uses the frozen ``w_fixed``
    (area and Omega already inside) times ln10."""
    logL = ctx.logL_grid.double().cpu().numpy()
    nf = logL.shape[0]
    if fix_comp:
        w = ctx.w_fixed.double().cpu().numpy() * LN10
        logf = np.zeros_like(logL) + _LOGF_REF
    else:
        om0_f = ctx.omega0_f.double().cpu().numpy() / SQARCSEC_PER_SR
        w = ctx.w_open.double().cpu().numpy() * om0_f[:, None, None] * LN10
        logf = ctx.logf_grid.double().cpu().numpy()
    gcols = []
    for f in range(nf):
        ll, lf = logL[f].ravel(), logf[f].ravel()
        gcols.append({
            "logf": lf, "a": LN10 * (ll - lref),
            "p": 10.0 ** np.clip(ll - lref, -30.0, 25.0),
            "r": 10.0 ** np.clip(lf - _LOGF_REF, -30.0, 25.0),
            "w": w[f].ravel(),
        })
    return gcols


def _concat(per_field, names):
    """Concatenate per-field column dicts -> (arrays by name, offsets)."""
    counts = [len(cols[names[0]]) for cols in per_field]
    off = tuple(int(x) for x in np.concatenate([[0], np.cumsum(counts)]))
    return {nm: np.concatenate([cols[nm] for cols in per_field])
            for nm in names}, off


def _chunk_table(grid_off, src_off, size=CHUNK_CELLS):
    """(field, start, end, is_source) rows cutting every field's cells
    and sources into pieces of at most ``size``: the streaming kernels'
    run table (:func:`prepare_cuda_stream_data`)."""
    rows = []
    for is_src, off in ((0, grid_off), (1, src_off)):
        for f in range(len(off) - 1):
            for s in range(off[f], off[f + 1], size):
                rows.append((f, s, min(s + size, off[f + 1]), is_src))
    return np.asarray(rows, dtype=np.int32).reshape(-1, 4)


def _vg_pieces(grid_off, src_off, piece):
    """``(field, start, end, is_source)`` rows cutting every field's cells,
    then its sources, into ``ceil(n / piece)`` pieces of near-equal length
    (at most ``piece``): a launch's blocks each take one."""
    rows = []
    for is_src, off in ((0, grid_off), (1, src_off)):
        for f in range(len(off) - 1):
            n = off[f + 1] - off[f]
            k = -(-n // piece)
            cuts = [off[f] + c for c in _near_equal(n, k)] if n else []
            rows += [(f, a, b, is_src) for a, b in zip(cuts, cuts[1:])]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 4)


def _vg_table(tab, piece, device):
    """``(piece, pieces, segments)`` on ``device`` for the piece table
    ``tab``: ``segments`` has one row ``(field, first piece, end piece,
    is_source)`` for each run of pieces of one field and kind, over which
    the last block of a walker tile sums the partials."""
    first = np.flatnonzero(np.r_[True, (tab[1:, [0, 3]]
                                        != tab[:-1, [0, 3]]).any(1)])
    segs = np.stack([tab[first, 0], first, np.r_[first[1:], len(tab)],
                     tab[first, 3]], axis=1).astype(np.int32)
    return (piece, torch.as_tensor(tab, device=device),
            torch.as_tensor(segs, device=device))


def _vg_tables(grid_off, src_off, device):
    """For each piece length of ``VG_PIECES``: ``(piece, pieces,
    segments)``, the kernels' launch tables. ``pieces`` is
    :func:`_vg_pieces` at that length (block ``p`` of a launch runs row
    ``p``); ``segments`` as :func:`_vg_table` makes them."""
    return tuple(_vg_table(_vg_pieces(grid_off, src_off, piece), piece,
                           device) for piece in VG_PIECES)


def _near_equal(n, k):
    """``k + 1`` cuts of ``range(n)`` into ``k`` near-equal runs."""
    return [i * n // k for i in range(k + 1)]


def _z_band_rows(shape, piece):
    """The most L rows a band of the z tables' length ``piece`` holds:
    each field's ``S_L`` rows cut into near-equal bands of about ``piece
    // S_z`` rows (at least one)."""
    _, sl, sz = shape
    k = -(-sl // min(sl, max(1, piece // sz)))
    return -(-sl // k)


def _z_vg_tables(shape, nsrc, device):
    """The z model's ``(piece, pieces, segments)`` for each length of
    ``VG_Z_PIECES`` (cells): ``pieces`` holds ``(field, first row, end
    row, 0)`` for each band of :func:`_z_band_rows` rows of each field's
    (S_L, S_z) panel, then ``(0, first source, end source, 1)`` for the
    sources cut into near-equal pieces of at most ``piece``; segments as
    :func:`_vg_table` makes them (one for each field's bands, one for the
    sources)."""
    nf, sl, _ = shape
    out = []
    for piece in VG_Z_PIECES:
        cuts = _near_equal(sl, -(-sl // _z_band_rows(shape, piece)))
        rows = [(f, a, b, 0) for f in range(nf)
                for a, b in zip(cuts, cuts[1:])]
        cuts = _near_equal(nsrc, -(-nsrc // piece)) if nsrc else []
        rows += [(0, a, b, 1) for a, b in zip(cuts, cuts[1:])]
        out.append(_vg_table(np.asarray(rows, dtype=np.int32), piece,
                             device))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _z_phases(s_z: int, rows: int) -> int:
    """The row phases ``G`` of ``z_lnlike_vg``'s bands of at most
    ``rows`` rows at ``S_z`` nodes: the kernel's ``THREADS`` threads take
    the band's ``S_z G`` (node, phase) pairs in turn, a pair the rows
    ``phase, phase + G, ...`` of its node's column, and pay about one
    cell's work a pair to start it and to contract its sums. ``G`` is the
    smallest that minimises a thread's work, ``ceil(S_z G / THREADS) x
    (ceil(rows / G) + 1)`` cells: at 201 nodes and 34 rows 5 (4 pairs of
    7 rows a thread, where one node a thread leaves 55 lanes idle), at 32
    nodes 8 (every lane one pair)."""
    def work(g):
        return -(-s_z * g // THREADS) * (-(-rows // g) + 1)
    return min(range(1, rows + 1), key=lambda g: (work(g), g))


def _vg_geometry(npieces: dict, nwalkers: int, nsm: int, tiles) -> tuple:
    """``(tile, piece)`` of a one-launch kernel for ``nwalkers`` on a
    card of ``nsm`` SMs: of the walker tiles ``tiles`` no larger than
    ``nwalkers`` and the piece lengths of its tables, whose grid is
    ``npieces[piece]`` pieces by ``ceil(nwalkers / tile)`` tiles, the
    candidate with the most work a block (tile x piece), the
    tile listed first in ``tiles`` at equal work, among those with at
    least 1.5 blocks per SM: every block pays a fixed cost (its piece and
    feature loads, its reduction and ticket), and fewer blocks than that
    left SMs idle or unevenly loaded in the sweep of
    ``tools/vg_turns.py`` (PERF.md). Where no grid has that many blocks,
    tile 1 and the shortest piece."""
    best = None
    for tile in tiles:
        if tile > nwalkers:
            continue
        for piece in npieces:
            if 2 * -(-nwalkers // tile) * npieces[piece] >= 3 * nsm:
                key = (tile * piece, -tiles.index(tile))
                if best is None or key > best[0]:
                    best = (key, (tile, piece))
    return best[1] if best else (1, min(npieces))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, asked once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def prepare_cuda_data(ctx: LFContext, fix_comp: bool, fcmin: float = 0.0,
                      dtype=None) -> CudaGridData:
    """Pack the context grids and sources into the kernel layout, on the
    context's device, in ``dtype`` (default: the context's)."""
    device = ctx.lum.device
    dtype = dtype or ctx.lum.dtype
    lref = float(ctx.lref)
    nf = int(ctx.logL_grid.shape[0])
    gcols = _grid_cols(ctx, fix_comp, lref)
    g, grid_off = _concat(gcols, ["logf", "a", "p", "r", "w"])

    src_off = (0,) * (nf + 1)
    s = {}
    if not fix_comp:
        # sources sorted by field (stable, in-field order kept)
        fid = ctx.field_id.cpu().numpy()
        lum = ctx.lum.double().cpu().numpy()
        logf_s = ctx.logf_src.double().cpu().numpy()
        om0_s = ctx.omega0_src.double().cpu().numpy() / SQARCSEC_PER_SR
        mask = ctx.src_mask.double().cpu().numpy()
        scols = []
        for f in range(nf):
            sel = np.nonzero(fid == f)[0]
            scols.append({
                "logf": logf_s[sel], "a": LN10 * (lum[sel] - lref),
                "p": 10.0 ** np.clip(lum[sel] - lref, -30.0, 25.0),
                "r": 10.0 ** np.clip(logf_s[sel] - _LOGF_REF, -30.0, 25.0),
                "lnom0": np.log(np.maximum(om0_s[sel], 1e-300)),
                "mask": mask[sel],
            })
        s, src_off = _concat(scols, ["logf", "a", "p", "r", "lnom0",
                                     "mask"])

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def opt(a, nm):
        return None if fix_comp else t(a[nm])

    return CudaGridData(
        g_a=t(g["a"]), g_p=t(g["p"]), g_w=t(g["w"]),
        g_logf=opt(g, "logf"), g_r=opt(g, "r"),
        s_logf=opt(s, "logf"), s_a=opt(s, "a"), s_p=opt(s, "p"),
        s_r=opt(s, "r"), s_lnom0=opt(s, "lnom0"), s_mask=opt(s, "mask"),
        grid_off=grid_off, src_off=src_off, lref=lref, nfields=nf,
        fcmin=float(fcmin) if fcmin else 0.0,
        # padded sources (src_mask 0) repeat a real row: masked out here
        # as in the context's own sums
        ln_sums=(float(ctx.nsrc), float(((ctx.lum.double() - lref)
                                          * ctx.src_mask.double()).sum()),
                 float(ctx.sum_pow_lum), float(ctx.sum_ln_om)),
        vg_tables=_vg_tables(grid_off, src_off, device),
        vg_tickets=torch.zeros(MAX_ROWS, dtype=torch.int32, device=device))


def prepare_cuda_h_data(ctx: LFContext, layout: ThetaLayoutH,
                        dtype=None) -> CudaGridData:
    """The fixed-completeness packing plus what the hierarchical feature
    map needs: the per-field float64 sums of the collapsed ln-terms,
    taken over the context's sources with luminosities relative to
    ``lref``, and the prior box."""
    data = prepare_cuda_data(ctx, fix_comp=True, dtype=dtype)
    nf = data.nfields
    if nf > MAX_HIER_FIELDS:
        raise ValueError(f"the hierarchical kernels take at most "
                         f"{MAX_HIER_FIELDS} fields, got {nf}")
    rel = ctx.lum.double() - data.lref
    mask = ctx.src_mask.double()
    cols = torch.stack([mask, mask * rel, mask * torch.exp(LN10 * rel),
                        mask * ctx.ln_om_src.double()])
    sums = torch.zeros((4, nf), dtype=torch.float64, device=rel.device)
    sums.index_add_(1, ctx.field_id, cols)
    lo, hi = layout.bounds_arrays(torch.float64, rel.device)
    return dataclasses.replace(data, ln_sums_f=sums, lo=lo, hi=hi)


@dataclass(frozen=True)
class CudaZData:
    """Packed arrays for the z-model kernels (fixed completeness: Omega
    lives in the frozen weights).

    Grid arrays are (C,) in the context's (F, S_L, S_z) order, z
    contiguous, so the z nodes of a field, ``n_dz``/``n_dz2`` (F * S_z,),
    index a cell's last axis; source arrays are (N,). ``vg_tables`` and
    ``vg_tickets`` are the launch tables and tickets of both kernels,
    ``z_lnlike`` and ``z_lnlike_vg`` (:func:`_z_vg_tables`). ``lo``/``hi``
    are the prior box in float64, for the feature map's clamp.
    """

    g_a: torch.Tensor       # LN10 * (logL - lref)
    g_p: torch.Tensor       # 10^(logL - lref)
    g_w: torch.Tensor       # frozen w_fixed; ln(ln10) rides in feature 2
    n_dz: torch.Tensor      # z node - z2
    n_dz2: torch.Tensor
    s_a: torch.Tensor
    s_dz: torch.Tensor      # source z - z2
    s_dz2: torch.Tensor
    s_lnom0: torch.Tensor   # ln Omega_src (frozen)
    s_mask: torch.Tensor
    shape: tuple            # (F, S_L, S_z)
    lref: float
    lo: torch.Tensor
    hi: torch.Tensor
    vg_tables: tuple = ()
    vg_tickets: Optional[torch.Tensor] = None  # (MAX_ROWS,) int32


def prepare_cuda_z_data(ctx: LFContext, layout: ThetaLayoutZ,
                        dtype=None) -> CudaZData:
    """Pack the context's grids and sources into the z kernels' layout,
    on the context's device, in ``dtype`` (default: the context's).
    Everything is formed in float64 and cast once."""
    device = ctx.lum.device
    dtype = dtype or ctx.lum.dtype
    lref = float(ctx.lref)
    logL = ctx.logL_grid.double().cpu().numpy()
    dz = ctx.zarr.double().cpu().numpy() - layout.z2          # (F, S_z)
    lum = ctx.lum.double().cpu().numpy()
    dzs = ctx.zsrc.double().cpu().numpy() - layout.z2

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a).ravel(), dtype=dtype,
                               device=device)

    lo, hi = layout.bounds_arrays(torch.float64, device)
    return CudaZData(
        g_a=t(LN10 * (logL - lref)),
        g_p=t(10.0 ** np.clip(logL - lref, -30.0, 25.0)),
        g_w=t(ctx.w_fixed.double().cpu().numpy()),
        n_dz=t(dz), n_dz2=t(dz * dz),
        s_a=t(LN10 * (lum - lref)), s_dz=t(dzs), s_dz2=t(dzs * dzs),
        s_lnom0=t(ctx.ln_om_src.double().cpu().numpy()),
        s_mask=t(ctx.src_mask.double().cpu().numpy()),
        shape=tuple(int(n) for n in logL.shape), lref=lref, lo=lo, hi=hi,
        vg_tables=_z_vg_tables(logL.shape, len(lum), device),
        vg_tickets=torch.zeros(MAX_ROWS, dtype=torch.int32, device=device))


@dataclass(frozen=True)
class CudaStreamData:
    """The streaming kernels' per-shard layout (free completeness).

    Grid arrays are (C,), fields back to back, with the quadrature
    weights divided by ``nshards``; source arrays are (shards held, S):
    every shard, or on a source-sharded grid only its rank's. Shard k
    holds every ``nshards``-th source of each field, each field padded
    to a whole number of ``CHUNK_CELLS``-source tiles (mask 0 in the
    padding), at offsets ``src_off`` shared by every shard. ``runs`` is
    the (nruns, 4) int32 launch table ``(field, start, end, is_source)``
    of one field's grid cells or source tiles, at most ``run_pieces``
    tiles (or as many cells) a run: one kernel block stages a run's
    source tiles together and runs every walker of its group against
    them. ``waves`` is, for the value and the value+gradient kernel, the
    number of blocks that fill the card once at ``run_pieces`` (0 off
    the card). ``logf`` is relative to ``_LOGF_REF``. ``sums`` is
    (shards held, 4) float64: each shard's ``(n, sum(lum - lref), sum P, sum
    ln Omega0)`` over its unmasked sources, the sums of
    :func:`_collapsed`, for the theta-affine source terms.
    """

    g_logf: torch.Tensor     # log10 flux - _LOGF_REF
    g_a: torch.Tensor        # LN10 * (logL - lref)
    g_p: torch.Tensor        # 10^(logL - lref)
    g_r: torch.Tensor        # 10^(logf - _LOGF_REF)
    g_w: torch.Tensor        # weight * area * ln10 / nshards
    s_logf: torch.Tensor     # (shards held, S)
    s_r: torch.Tensor
    s_mask: torch.Tensor
    sums: torch.Tensor       # (shards held, 4) float64
    runs: torch.Tensor
    run_pieces: int
    waves: tuple             # (value, value+gradient) blocks per wave
    grid_off: tuple
    src_off: tuple
    lref: float
    nfields: int
    fcmin: float
    nshards: int


@functools.lru_cache(maxsize=None)
def _stream_blocks_per_sm(index: int, vg: bool, run_pieces: int) -> int:
    """Blocks of a streaming partial kernel (``vg``: the value+gradient
    one) that one SM of CUDA device ``index`` holds at once, with runs of
    ``run_pieces`` tiles staged: the card's own occupancy query, made
    once per device (a failed query raises and is not kept)."""
    from lumfuncmcmc_tpu_torch.ops._build import load_library
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = load_library().free_stream_blocks_per_sm(
            int(vg), run_pieces, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"streaming kernel occupancy query failed: CUDA "
                           f"error {rc}, {blocks.value} blocks per SM")
    return blocks.value


def _run_pieces(ntiles: int, wave) -> int:
    """Source tiles per run of the streaming kernels: the fewest that let
    the ``ceil(ntiles / run)`` source runs fill at most half of the value
    kernel's wave, ``wave(run)`` blocks, so that the wave holds two walker
    groups of every run (one group, with runs cut to fill the whole wave,
    left a third of the card idle: PERF.md), at most ``STREAM_MAX_RUN``
    (the shared memory of a block's staged tiles)."""
    for rp in range(1, STREAM_MAX_RUN):
        if 2 * -(-ntiles // rp) <= wave(rp):
            return rp
    return STREAM_MAX_RUN


def _stream_waves(device: torch.device, run_pieces: int) -> tuple:
    """(value, value+gradient): blocks of each streaming partial kernel
    that fill ``device`` once at ``run_pieces`` tiles a run; (0, 0) off
    the card, where nothing launches."""
    if device.type != "cuda":
        return (0, 0)
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    return tuple(nsm * _stream_blocks_per_sm(device.index, vg, run_pieces)
                 for vg in (False, True))


def prepare_cuda_stream_data(ctx: LFContext, fcmin: float, nshards: int = 1,
                             dtype=None,
                             shard: Optional[int] = None) -> CudaStreamData:
    """Pack the context into the streaming kernels' per-shard layout, on
    the context's device, in ``dtype`` (default: the context's); the
    counterpart of ``prepare_pallas_data(..., flat=False,
    src_row_align=_SLAB_ROWS)`` (one shard) and
    ``prepare_stream_shard_data`` (``pallas_lnlike.py:299``, ``:346``).
    ``shard``: pack only that shard's sources (a source-sharded grid's
    rank holds its own), else all ``nshards``."""
    device = ctx.lum.device
    dtype = dtype or ctx.lum.dtype
    lref = float(ctx.lref)
    nf = int(ctx.logL_grid.shape[0])
    gcols = _grid_cols(ctx, False, lref)
    for cols in gcols:
        cols["logf"] = cols["logf"] - _LOGF_REF
        cols["w"] = cols["w"] / float(nshards)
    g, grid_off = _concat(gcols, ["logf", "a", "p", "r", "w"])

    fid = ctx.field_id.cpu().numpy()
    lum = ctx.lum.double().cpu().numpy()
    logf = ctx.logf_src.double().cpu().numpy() - _LOGF_REF
    om0 = ctx.omega0_src.double().cpu().numpy() / SQARCSEC_PER_SR
    mask = ctx.src_mask.double().cpu().numpy()
    terms = np.stack([mask, mask * (lum - lref),
                      mask * 10.0 ** np.clip(lum - lref, -30.0, 25.0),
                      mask * np.log(np.maximum(om0, 1e-300))])
    sel_f = [np.nonzero(fid == f)[0] for f in range(nf)]
    per_shard = [-(-len(s) // nshards) for s in sel_f]      # ceil
    padded = [-(-n // CHUNK_CELLS) * CHUNK_CELLS for n in per_shard]
    src_off = tuple(int(x) for x in np.concatenate([[0],
                                                    np.cumsum(padded)]))
    held = range(nshards) if shard is None else [int(shard)]
    s_logf = np.zeros((len(held), src_off[-1]))
    s_r = np.ones((len(held), src_off[-1]))
    s_mask = np.zeros((len(held), src_off[-1]))
    sums = np.zeros((len(held), 4))
    for row, k in enumerate(held):
        for f in range(nf):
            idx = sel_f[f][k::nshards]
            at = slice(src_off[f], src_off[f] + len(idx))
            s_logf[row, at] = logf[idx]
            s_r[row, at] = 10.0 ** np.clip(logf[idx], -30.0, 25.0)
            s_mask[row, at] = mask[idx]
            sums[row] += terms[:, idx].sum(axis=1)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    # on the CPU (no wave) every run is as long as a block can stage
    rlen = _run_pieces(src_off[-1] // CHUNK_CELLS,
                       lambda rp: _stream_waves(device, rp)[0])
    return CudaStreamData(
        g_logf=t(g["logf"]), g_a=t(g["a"]), g_p=t(g["p"]), g_r=t(g["r"]),
        g_w=t(g["w"]), s_logf=t(s_logf), s_r=t(s_r), s_mask=t(s_mask),
        sums=torch.as_tensor(sums, dtype=torch.float64, device=device),
        runs=torch.as_tensor(_chunk_table(grid_off, src_off,
                                          rlen * CHUNK_CELLS),
                             device=device),
        run_pieces=rlen, waves=_stream_waves(device, rlen),
        grid_off=grid_off, src_off=src_off, lref=lref, nfields=nf,
        fcmin=float(fcmin) if fcmin else 0.0, nshards=int(nshards))


# ---------------------------------------------------------------------------
# feature maps (theta -> per-walker kernel scalars)
# ---------------------------------------------------------------------------
#
# Every map runs in float64 and returns float64 rows whose values are
# rounded to the kernels' dtype (:func:`_round_st`): the kernels read
# exactly these numbers, and so do the float64 terms added on the host
# (the collapsed ln-terms), so every feature that the grid integral and
# the source sum share is the same number in both. Near the mode the two
# parts cancel to O(1) out of ~N: were they to read two different
# roundings of ``LN10 phistar`` (~1e-6 apart), lnL would move by ~N 1e-6,
# independently for two close thetas.

def _round_st(f, dtype):
    """float64 ``f`` rounded to ``dtype`` and held as float64. The
    rounding is a straight-through one: autograd sees the identity, so
    the gradient stays float64."""
    return f + (f.to(dtype).double() - f).detach()


def _feat_free_one(theta, layout: ThetaLayout, lref: float, fcmin: float):
    """(W, D) thetas -> (W, 6+2F) free-completeness features::

        0 c_grid = LN10*phistar            3 lA = LN10*(Lstar - lref)
        1 c_src  = ln(ln10) + LN10*phistar 4 t1 = 10^(lref - Lstar)
        2 aA = sch_al + 1                  5 alpha_c
        6+f    logF50_f
        6+F+f  t2_f = 10^(logf_ref - log_ftau_f)   (1 when fcmin = 0:
                                                    the kernels skip it)
    """
    lstar, phistar, sch_al, logf50, alpha_c = layout.unpack(theta)
    if fcmin:
        log_ftau = logf50 + _log10_inverse_fleming_ratio(
            alpha_c, fcmin)[:, None]
        t2 = 10.0 ** (_LOGF_REF - log_ftau)
    else:
        t2 = torch.ones_like(logf50)
    return torch.cat([
        torch.stack([LN10 * phistar,
                     _LOG_LN10 + LN10 * phistar,
                     sch_al + 1.0,
                     LN10 * (lstar - lref),
                     10.0 ** (lref - lstar),
                     alpha_c], dim=1),
        logf50,
        t2,
    ], dim=1)


def _feat_fixed_one(theta, layout: ThetaLayout, lref: float):
    """(W, D) thetas -> (W, 4) fixed-completeness features
    ``[c_grid, aA, lA, t1]`` (``c_grid = LN10*phistar``, the rest as in
    :func:`_feat_free_one`)."""
    lstar, phistar, sch_al, _, _ = layout.unpack(theta)
    return torch.stack([LN10 * phistar, sch_al + 1.0, LN10 * (lstar - lref),
                        10.0 ** (lref - lstar)], dim=1)


def _collapsed(n, sum_rel, sum_pow, sum_om, c, aA, lA, t1):
    """The collapsed ln-term ``sum mask [ln(ln10) + c + aA (a - lA) - P t1
    + ln Omega]`` of a source set from its float64 catalog sums (count,
    ``sum(lum - lref)``, ``sum P``, ``sum ln Omega``) and the rounded
    features."""
    return (n * (_LOG_LN10 + c) + aA * (LN10 * sum_rel - n * lA)
            - t1 * sum_pow + sum_om)


def _fixed_collapsed(feats, data: CudaGridData):
    """(W,) float64: fixed completeness's collapsed ln-term
    (``_ln_term_collapsed``) from the rounded features, added on the
    host after the kernel's grid integral."""
    return _collapsed(*data.ln_sums, *feats.unbind(dim=1))


def _features(thetas, data: CudaGridData, layout: ThetaLayout, dtype):
    """(W, D) thetas -> the single-epoch kernels' feature rows, rounded
    to ``dtype`` (:func:`_round_st`): :func:`_clamp_flim`, then the
    completeness family's feature map."""
    th = _clamp_flim(thetas.double(), layout)
    if layout.fix_comp:
        feats = _feat_fixed_one(th, layout, data.lref)
    else:
        feats = _feat_free_one(th, layout, data.lref, data.fcmin)
    return _round_st(feats, dtype)


def _feat_z_one(theta, layout: ThetaLayoutZ, lref: float):
    """(W, D) z-model thetas -> (W, 7) quadratic-coefficient features,
    the quadratics taken in ``dz = z - z2`` and Lstar relative to
    ``lref``::

        0 LN10*pcurv   1 LN10*pslope   2 LN10*phi2 + ln(ln10)
        3 LN10*Lcurv   4 LN10*Lslope   5 LN10*(L2 - lref)
        6 aA = sch_al + 1

    so ``LN10*phistar(z) + ln(ln10) = f0 dz^2 + f1 dz + f2`` and
    ``lq(z) = LN10*(Lstar(z) - lref) = f3 dz^2 + f4 dz + f5``.
    """
    L1, L2, L3, p1, p2, p3, al = layout.unpack(theta)
    d1, d3 = layout.z1 - layout.z2, layout.z3 - layout.z2

    def curv_slope(y1, y2, y3):
        s1, s3 = (y1 - y2) / d1, (y3 - y2) / d3
        curv = (s1 - s3) / (d1 - d3)
        return curv, s1 - curv * d1

    pc, ps = curv_slope(p1, p2, p3)
    lc, ls = curv_slope(L1, L2, L3)
    return torch.stack([LN10 * pc, LN10 * ps, LN10 * p2 + _LOG_LN10,
                        LN10 * lc, LN10 * ls, LN10 * (L2 - lref),
                        al + 1.0], dim=1)


def _features_z(thetas, data: CudaZData, layout: ThetaLayoutZ, dtype):
    """(W, D) thetas -> the z kernels' (W, 7) feature rows, rounded to
    ``dtype``. The pivot algebra runs in float64 (its differences of
    ~42-sized pivots over ~0.3-sized spacings lose ~1e-5 relative in
    float32). Thetas are clamped to the prior box first: a row the
    caller masks keeps finite features, whatever its theta, so its
    gradient is an exact 0. The source sum is in the kernel, beside the
    grid integral, so both read the same rounded features."""
    th = torch.clamp(thetas.double(), data.lo, data.hi)
    return _round_st(_feat_z_one(th, layout, data.lref), dtype)


def _feat_h_one(theta, data: CudaGridData, layout: ThetaLayoutH):
    """(W, D) float64 hierarchical thetas -> (W, 1+3F) features, the
    column order of the TPU's ``_feat_h_one`` without its ``lnrest``::

        0 aA = sch_al + 1
        1+3f c_f = LN10*phistar_f    2+3f lA_f = LN10*(Lstar_f - lref)
        3+3f t1_f = 10^(lref - Lstar_f)
    """
    _, _, _, _, sch_al, lstar_f, phistar_f = layout.unpack(theta)
    dl = data.lref - lstar_f
    per_field = torch.stack([LN10 * phistar_f, -LN10 * dl,
                             torch.exp(LN10 * dl)], dim=2)
    return torch.cat([(sch_al + 1.0)[:, None],
                      per_field.reshape(theta.shape[0], -1)], dim=1)


def _features_hier(thetas, data: CudaGridData, layout: ThetaLayoutH, dtype):
    """(W, D) thetas -> the hierarchical kernels' (W, 1+3F) feature rows,
    rounded to ``dtype``. Thetas are clamped to the prior box first, so a
    row the caller masks (``Lstar_f`` far outside, ``sig <= 0``) keeps
    finite features and its gradient is an exact 0."""
    th = torch.clamp(thetas.double(), data.lo, data.hi)
    return _round_st(_feat_h_one(th, data, layout), dtype)


def _hier_lnpart_f(feats, data: CudaGridData):
    """(W, F) float64: the per-field collapsed ln-terms from the rounded
    features and the per-field float64 catalog sums (the data term)."""
    pf = feats[:, 1:].reshape(feats.shape[0], -1, 3)
    return _collapsed(*data.ln_sums_f, pf[..., 0], feats[:, :1],
                      pf[..., 1], pf[..., 2])


def _hier_hyper_f(thetas, data: CudaGridData, layout: ThetaLayoutH):
    """(W, F) float64: the Gaussian population hyperprior of each field
    (the prior measure). It is O(1) and smooth, so it is taken from the
    float64 (clamped) thetas; its ``-ln sig`` and ``((x - mu)/sig)^2``
    keep their size beside the ~1e4-sized terms of both signs only in
    float64."""
    th = torch.clamp(thetas.double(), data.lo, data.hi)
    mu_l, sig_l, mu_p, sig_p, _, lstar_f, phistar_f = layout.unpack(th)
    return (_ln_normal(lstar_f, mu_l[:, None], sig_l[:, None])
            + _ln_normal(phistar_f, mu_p[:, None], sig_p[:, None]))


def _hier_collapsed(feats, thetas, data: CudaGridData, layout: ThetaLayoutH):
    """(W,) float64 ``lnrest``: :func:`_hier_lnpart_f` plus
    :func:`_hier_hyper_f`, summed over the fields."""
    return (_hier_lnpart_f(feats, data)
            + _hier_hyper_f(thetas, data, layout)).sum(dim=1)


def _features_stream(thetas, data: CudaStreamData, layout: ThetaLayout,
                     dtype):
    """(W, D) thetas -> the streaming kernels' (W, 6+2F) feature rows,
    rounded to ``dtype``: :func:`_feat_free_one`'s columns with ``lF50_f
    - _LOGF_REF`` (formed in float64, where ``lF50 ~ -16`` keeps its
    digits)."""
    th = _clamp_flim(thetas.double(), layout)
    f = _feat_free_one(th, layout, data.lref, data.fcmin)
    nf = data.nfields
    f = torch.cat([f[:, :6], f[:, 6:6 + nf] - _LOGF_REF, f[:, 6 + nf:]],
                  dim=1)
    return _round_st(f, dtype)


def _stream_collapsed(feats, data: CudaStreamData, shard: int = 0):
    """(W,) float64: shard ``shard``'s theta-affine source terms,
    :func:`_collapsed` of its float64 catalog sums, with ``c_s = c_g +
    ln(ln10)`` (``_feat_free_one``'s column 1 taken from column 0, so
    that the grid and source parts share one rounding of ``phistar``)."""
    return _collapsed(*data.sums[shard], feats[:, 0], feats[:, 2],
                      feats[:, 3], feats[:, 4])

# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def _ln_fc(logf, r, ac, lf50, t2, fcmin):
    """ln Fleming completeness for (W, n) cells; fc is clamped at 1e-30
    as in the TPU kernels, so an underflow cannot turn an in-bounds
    lnlike into -inf on one engine only."""
    x = ac * (logf - lf50)
    fc = torch.clamp(0.5 + 0.5 * x * torch.rsqrt(1.0 + x * x), min=1e-30)
    lf = torch.log(fc)
    if not fcmin:
        return lf
    return lf / (1.0 - torch.exp(-(r * t2)))


def _s64(x):
    """Row sums in float64 of terms evaluated in their own dtype (the
    kernels' float32 terms, double sums)."""
    return x.double().sum(dim=1)


def free_lnlike_reference(feats, data: CudaGridData):
    """Plain version of the free-completeness kernel: the same factored
    math per field, each term in the dtype of ``feats``, the sums in
    float64. (W, 6+2F) -> (W,) float64."""
    nf, fcmin = data.nfields, data.fcmin
    c_g, c_s, aA, lA, t1, ac = (feats[:, i:i + 1] for i in range(6))
    tot = torch.zeros(feats.shape[0], dtype=torch.float64,
                      device=feats.device)
    for f in range(nf):
        lf50 = feats[:, 6 + f:7 + f]
        t2 = feats[:, 6 + nf + f:7 + nf + f]
        g = slice(data.grid_off[f], data.grid_off[f + 1])
        e = (c_g + aA * (data.g_a[g] - lA) - data.g_p[g] * t1
             + _ln_fc(data.g_logf[g], data.g_r[g], ac, lf50, t2, fcmin))
        tot = tot - _s64(torch.exp(e) * data.g_w[g])
        s = slice(data.src_off[f], data.src_off[f + 1])
        contrib = (c_s + aA * (data.s_a[s] - lA) - data.s_p[s] * t1
                   + data.s_lnom0[s]
                   + _ln_fc(data.s_logf[s], data.s_r[s], ac, lf50, t2,
                            fcmin))
        tot = tot + _s64(torch.where(data.s_mask[s] > 0.0, contrib,
                                     torch.zeros_like(contrib)))
    return tot


def fixed_lnlike_reference(feats, data: CudaGridData):
    """Plain version of the fixed-completeness kernel: minus the grid
    integral (:func:`_fixed_collapsed` completes the lnlike).
    (W, 4) -> (W,) float64."""
    c, aA, lA, t1 = (feats[:, i:i + 1] for i in range(4))
    e = c + aA * (data.g_a - lA) - data.g_p * t1
    return -_s64(torch.exp(e) * data.g_w)


def _fc_terms(logf, r, ac, lf50, t2, fcmin):
    """(ln fc, d ln fc/dx, d ln fc/d t2) for (W, n) cells, the value
    part exactly as :func:`_ln_fc`: ``u = rsqrt(1+x^2)`` is reused for
    ``u^3`` and ``q = exp(-R t2)`` for the t2 derivative, so the
    gradient adds no transcendental (``_kernel_free_vg``'s
    ``fc_terms``, ``pallas_lnlike.py:870``)."""
    x = ac * (logf - lf50)
    u = torch.rsqrt(1.0 + x * x)
    fc = torch.clamp(0.5 + 0.5 * x * u, min=1e-30)
    lfc = torch.log(fc)
    dfx = 0.5 * u * u * u / fc
    if not fcmin:
        return lfc, dfx, torch.zeros_like(lfc)
    q = torch.exp(-(r * t2))
    inv_d = 1.0 / (1.0 - q)
    return lfc * inv_d, dfx * inv_d, -lfc * (r * q) * inv_d * inv_d


def free_lnlike_vg_reference(feats, data: CudaGridData):
    """Plain version of the free-completeness value+gradient kernel:
    (W, 6+2F) features -> (W, 7+2F) rows ``[lnl, d_cg, d_cs, d_aA, d_lA,
    d_t1, d_ac, d_lf50_0.., d_t2_0..]`` in float64, the column order of
    ``_kernel_free_vg``; ``d_t2`` is 0 when ``fcmin = 0``."""
    nf, fcmin = data.nfields, data.fcmin
    c_g, c_s, aA, lA, t1, ac = (feats[:, i:i + 1] for i in range(6))
    aA1, ac1 = aA[:, 0].double(), ac[:, 0].double()
    zero = torch.zeros(feats.shape[0], dtype=torch.float64,
                       device=feats.device)
    lnl, d_cg, d_cs, d_aA, d_lA, d_t1, d_ac = (zero,) * 7
    d_lf, d_t2 = [], []
    for f in range(nf):
        lf50 = feats[:, 6 + f:7 + f]
        t2 = feats[:, 6 + nf + f:7 + nf + f]
        g = slice(data.grid_off[f], data.grid_off[f + 1])
        logf = data.g_logf[g]
        lnfc, dfx, dft = _fc_terms(logf, data.g_r[g], ac, lf50, t2, fcmin)
        am = data.g_a[g] - lA
        p = data.g_p[g]
        e = torch.exp(c_g + aA * am - p * t1 + lnfc) * data.g_w[g]
        s0 = _s64(e)
        lnl, d_cg = lnl - s0, d_cg - s0
        d_lA = d_lA + aA1 * s0
        d_aA = d_aA - _s64(e * am)
        d_t1 = d_t1 + _s64(e * p)
        d_ac = d_ac - _s64(e * dfx * (logf - lf50))
        lf_f = ac1 * _s64(e * dfx)
        t2_f = -_s64(e * dft)

        s = slice(data.src_off[f], data.src_off[f + 1])
        m = data.s_mask[s]
        logf = data.s_logf[s]
        lnfc, dfx, dft = _fc_terms(logf, data.s_r[s], ac, lf50, t2, fcmin)
        am = data.s_a[s] - lA
        p = data.s_p[s]
        contrib = c_s + aA * am - p * t1 + data.s_lnom0[s] + lnfc
        lnl = lnl + _s64(torch.where(m > 0.0, contrib,
                                     torch.zeros_like(contrib)))
        s0 = m.double().sum()
        d_cs = d_cs + s0
        d_lA = d_lA - aA1 * s0
        d_aA = d_aA + _s64(m * am)
        d_t1 = d_t1 - (m * p).double().sum()
        d_ac = d_ac + _s64(m * dfx * (logf - lf50))
        d_lf.append(lf_f - ac1 * _s64(m * dfx))
        d_t2.append(t2_f + _s64(m * dft))
    return torch.stack([lnl, d_cg, d_cs, d_aA, d_lA, d_t1, d_ac]
                       + d_lf + d_t2, dim=1)


def free_stream_lnlike_reference(feats, data: CudaStreamData, shard=0):
    """Plain version of the streaming kernel for shard ``shard``: the
    source sum of ``mask ln fc`` less the grid integral at weights over
    ``nshards``, per field; each term in the dtype of ``feats``, the sums
    in float64, as in the kernel. (W, 6+2F) -> (W,);
    :func:`_stream_collapsed` completes the lnlike."""
    nf, fcmin = data.nfields, data.fcmin
    c_g, _, aA, lA, t1, ac = (feats[:, i:i + 1] for i in range(6))
    tot = torch.zeros(feats.shape[0], dtype=torch.float64,
                      device=feats.device)
    for f in range(nf):
        lf50 = feats[:, 6 + f:7 + f]
        t2 = feats[:, 6 + nf + f:7 + nf + f]
        g = slice(data.grid_off[f], data.grid_off[f + 1])
        e = (c_g + aA * (data.g_a[g] - lA) - data.g_p[g] * t1
             + _ln_fc(data.g_logf[g], data.g_r[g], ac, lf50, t2, fcmin))
        tot = tot - _s64(torch.exp(e) * data.g_w[g])
        s = slice(data.src_off[f], data.src_off[f + 1])
        lnfc = _ln_fc(data.s_logf[shard, s], data.s_r[shard, s], ac, lf50,
                      t2, fcmin)
        tot = tot + _s64(torch.where(data.s_mask[shard, s] > 0.0, lnfc,
                                     torch.zeros_like(lnfc)))
    return tot


def free_stream_lnlike_vg_reference(feats, data: CudaStreamData, shard=0):
    """Plain version of the streaming value+gradient kernel: (W, 6+2F)
    features -> (W, 7+2F) float64 rows ``[lnl, d_cg, d_cs, d_aA, d_lA,
    d_t1, d_ac, d_lf50_f.., d_t2_f..]`` of :func:`free_stream_lnlike`'s
    part of the lnlike (``d_cs`` is 0: the collapsed terms carry
    ``c_s``)."""
    nf, fcmin = data.nfields, data.fcmin
    c_g, _, aA, lA, t1, ac = (feats[:, i:i + 1] for i in range(6))
    zero = torch.zeros(feats.shape[0], dtype=torch.float64,
                       device=feats.device)
    lnl, d_cg, d_aA, d_lA, d_t1, d_ac = (zero,) * 6
    d_lf, d_t2 = [], []
    s64 = _s64
    for f in range(nf):
        lf50 = feats[:, 6 + f:7 + f]
        t2 = feats[:, 6 + nf + f:7 + nf + f]
        g = slice(data.grid_off[f], data.grid_off[f + 1])
        logf = data.g_logf[g]
        lnfc, dfx, dft = _fc_terms(logf, data.g_r[g], ac, lf50, t2, fcmin)
        am = data.g_a[g] - lA
        p = data.g_p[g]
        e = torch.exp(c_g + aA * am - p * t1 + lnfc) * data.g_w[g]
        s0 = s64(e)
        lnl, d_cg = lnl - s0, d_cg - s0
        d_lA = d_lA + aA[:, 0].double() * s0
        d_aA = d_aA - s64(e * am)
        d_t1 = d_t1 + s64(e * p)
        d_ac = d_ac - s64(e * dfx * (logf - lf50))
        lf_f = ac[:, 0].double() * s64(e * dfx)
        t2_f = -s64(e * dft)

        s = slice(data.src_off[f], data.src_off[f + 1])
        m = data.s_mask[shard, s]
        logf = data.s_logf[shard, s]
        lnfc, dfx, dft = _fc_terms(logf, data.s_r[shard, s], ac, lf50, t2,
                                   fcmin)
        lnl = lnl + s64(torch.where(m > 0.0, lnfc, torch.zeros_like(lnfc)))
        d_ac = d_ac + s64(m * dfx * (logf - lf50))
        d_lf.append(lf_f - ac[:, 0].double() * s64(m * dfx))
        d_t2.append(t2_f + s64(m * dft))
    return torch.stack([lnl, d_cg, zero, d_aA, d_lA, d_t1, d_ac]
                       + d_lf + d_t2, dim=1)


def fixed_lnlike_vg_reference(feats, data: CudaGridData):
    """Plain version of the fixed-completeness value+gradient kernel:
    (W, 4) -> (W, 5) float64 rows ``[lnl, d_c, d_aA, d_lA, d_t1]`` of
    :func:`fixed_lnlike`'s part of the lnlike."""
    c, aA, lA, t1 = (feats[:, i:i + 1] for i in range(4))
    am = data.g_a - lA
    e = torch.exp(c + aA * am - data.g_p * t1) * data.g_w
    s0 = _s64(e)
    return torch.stack([-s0, -s0, -_s64(e * am), aA[:, 0].double() * s0,
                        _s64(e * data.g_p)], dim=1)


def _z_node_rows(th, data: CudaZData, f: int):
    """Per z node of field ``f``, each (W, S_z): ``dz``, ``dz2`` (1, S_z)
    and the hoisted ``lq = LN10 (Lstar(z) - lref)``, ``t1 = exp(-lq) =
    10^(lref - Lstar(z))`` and ``base = pr - aA lq`` with ``pr`` the
    phistar quadratic, as ``(hi, lo)``: the node quantities are formed in
    float64 from the features, as the kernels form them, ``lq`` rounded
    once to the features' dtype and ``base = hi + lo`` split into two
    numbers of that dtype. A cell adds ``hi`` last (:func:`_z_cells`): an
    error in a node's ``base`` is shared by every cell of its column of
    the grid, so it would not average out over the integral: in float32
    it was the largest error in the lnp differences of close thetas at
    10^5-10^6 sources."""
    sz = data.shape[2]
    dz = data.n_dz[f * sz:(f + 1) * sz][None, :]
    dz2 = data.n_dz2[f * sz:(f + 1) * sz][None, :]
    t = [x.double() for x in th]
    z1, z2 = dz.double(), dz2.double()
    lq = t[3] * z2 + t[4] * z1 + t[5]
    base = t[0] * z2 + t[1] * z1 + t[2] - t[6] * lq
    dt = th[0].dtype
    lq, hi = lq.to(dt), base.to(dt)
    return dz, dz2, lq, torch.exp(-lq), (hi, (base - hi.double()).to(dt))


def _z_cells(th, data: CudaZData, f: int):
    """Field ``f``'s (W, S_L, S_z) cell terms ``exp(base + aA a - P t1) w``
    (with :func:`_z_node_rows`' split ``base``) and its node rows."""
    dz, dz2, lq, t1, (hi, lo) = _z_node_rows(th, data, f)
    a, p, w = _z_panel(data, f)
    e = hi[:, None, :] + ((th[6][:, :, None] * a - p * t1[:, None, :])
                          + lo[:, None, :])
    return torch.exp(e) * w, (dz, dz2, lq, t1), (a, p)


def _z_panel(data: CudaZData, f: int):
    """Field ``f``'s (1, S_L, S_z) panels of ``g_a``, ``g_p``, ``g_w``."""
    _, sl, sz = data.shape
    g = slice(f * sl * sz, (f + 1) * sl * sz)
    return (data.g_a[g].view(1, sl, sz), data.g_p[g].view(1, sl, sz),
            data.g_w[g].view(1, sl, sz))


def z_lnlike_reference(feats, data: CudaZData):
    """Plain version of the z-model kernel, in its hoisted form: per
    field and z node ``t1`` and ``base`` once, then one exp per cell,
    ``exp(base + aA a - P t1) w``; per source ``ln phi(a_s, z_s) +
    ln Omega_s`` with no clamp on ``x = a_s - lq``; each term in the
    dtype of ``feats``, the sums in float64. (W, 7) -> (W,) float64."""
    th = [feats[:, i:i + 1] for i in range(7)]
    tot = torch.zeros(feats.shape[0], dtype=torch.float64,
                      device=feats.device)
    for f in range(data.shape[0]):
        tot = tot - _z_cells(th, data, f)[0].double().sum(dim=(1, 2))
    lq = th[3] * data.s_dz2 + th[4] * data.s_dz + th[5]
    x = data.s_a - lq
    contrib = (th[0] * data.s_dz2 + th[1] * data.s_dz + th[2] + th[6] * x
               - torch.exp(x) + data.s_lnom0)
    return tot + _s64(torch.where(data.s_mask > 0.0, contrib,
                                  torch.zeros_like(contrib)))


def z_lnlike_vg_reference(feats, data: CudaZData):
    """Plain version of the z-model value+gradient kernel: (W, 7)
    features -> (W, 8) float64 rows ``[lnl, d/d(f0..f6)]``. Per z node
    three column sums over the L rows (``E``, ``E P``, ``E a``) are
    contracted with ``dz``, ``dz2``, ``t1`` and ``lq``; the source part
    clamps ``x`` at ``X_CLAMP``, as ``_kernel_z_vg`` does. Terms in the
    dtype of ``feats``, sums and contractions in float64."""
    th = [feats[:, i:i + 1] for i in range(7)]
    aA = th[6][:, 0].double()
    zero = torch.zeros(feats.shape[0], dtype=torch.float64,
                       device=feats.device)
    lnl, d = zero, [zero] * 7
    for f in range(data.shape[0]):
        e, (dz, dz2, lq, t1), (a, p) = _z_cells(th, data, f)
        col_e = e.double().sum(dim=1)                       # (W, S_z)
        tp = t1.double() * (e * p).double().sum(dim=1)
        dz, dz2, lq = dz.double(), dz2.double(), lq.double()
        s0 = col_e.sum(dim=1)
        cez, cez2 = (col_e * dz).sum(dim=1), (col_e * dz2).sum(dim=1)
        lnl = lnl - s0
        d = [d[0] - cez2, d[1] - cez, d[2] - s0,
             d[3] + aA * cez2 - (tp * dz2).sum(dim=1),
             d[4] + aA * cez - (tp * dz).sum(dim=1),
             d[5] + aA * s0 - tp.sum(dim=1),
             d[6] - ((e * a).double().sum(dim=(1, 2))
                     - (lq * col_e).sum(dim=1))]
    m, dz, dz2 = data.s_mask, data.s_dz, data.s_dz2
    lq = th[3] * dz2 + th[4] * dz + th[5]
    x = torch.clamp(data.s_a - lq, max=X_CLAMP)
    ex = torch.exp(x)
    contrib = (th[0] * dz2 + th[1] * dz + th[2] + th[6] * x - ex
               + data.s_lnom0)
    lnl = lnl + _s64(torch.where(m > 0.0, contrib,
                                 torch.zeros_like(contrib)))
    mr = m * (th[6] - ex)
    d = [d[0] + (m * dz2).double().sum(), d[1] + (m * dz).double().sum(),
         d[2] + m.double().sum(), d[3] - _s64(mr * dz2),
         d[4] - _s64(mr * dz), d[5] - _s64(mr), d[6] + _s64(m * x)]
    return torch.stack([lnl] + d, dim=1)


def _hier_field_sums(feats, data: CudaGridData, f: int):
    """Field ``f``'s ``(s0, s1, s2)``, each (W,) float64: the sums over
    its cells of ``e``, ``e (a - lA_f)`` and ``e P`` with ``e = exp(c_f +
    aA (a - lA_f) - P t1_f) w``, each term in the dtype of ``feats``."""
    aA = feats[:, 0:1]
    c, lA, t1 = (feats[:, 1 + 3 * f + i:2 + 3 * f + i] for i in range(3))
    g = slice(data.grid_off[f], data.grid_off[f + 1])
    am = data.g_a[g] - lA
    e = torch.exp(c + aA * am - data.g_p[g] * t1) * data.g_w[g]
    return _s64(e), _s64(e * am), _s64(e * data.g_p[g])


def hier_lnlike_reference(feats, data: CudaGridData):
    """Plain version of the hierarchical kernel: minus every field's
    integral at its own ``(c_f, lA_f, t1_f)`` (:func:`_hier_collapsed`
    completes the lnlike). (W, 1+3F) -> (W,) float64."""
    tot = torch.zeros(feats.shape[0], dtype=torch.float64,
                      device=feats.device)
    for f in range(data.nfields):
        tot = tot - _hier_field_sums(feats, data, f)[0]
    return tot


def hier_lnlike_vg_reference(feats, data: CudaGridData):
    """Plain version of the hierarchical value+gradient kernel:
    (W, 1+3F) -> (W, 2+3F) float64 rows ``[lnl, d_aA, (d_c_f = -s0_f,
    d_lA_f = aA s0_f, d_t1_f = s2_f) x F]``, the column order of
    ``_kernel_hier_vg`` without its ``lnrest`` column."""
    aA = feats[:, 0].double()
    lnl, d_aA, cols = torch.zeros_like(aA), torch.zeros_like(aA), []
    for f in range(data.nfields):
        s0, s1, s2 = _hier_field_sums(feats, data, f)
        lnl, d_aA = lnl - s0, d_aA - s1
        cols += [-s0, aA * s0, s2]
    return torch.stack([lnl, d_aA] + cols, dim=1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda_inputs(feats, nfeat, tables, arrays):
    if feats.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32 features, got "
                        f"{feats.dtype}")
    if feats.dim() != 2 or feats.shape[1] != nfeat:
        raise ValueError(f"features must be (W, {nfeat}), got "
                         f"{tuple(feats.shape)}")
    if not 0 < feats.shape[0] <= MAX_ROWS:
        raise ValueError(f"walker batch of {feats.shape[0]} is outside "
                         f"the kernel's 1..{MAX_ROWS} launch range")
    if not feats.is_contiguous():
        raise ValueError("features must be contiguous")
    for a in arrays + tables:
        if a.device != feats.device:
            raise ValueError(f"grid data on {a.device}, features on "
                             f"{feats.device}")
        if not a.is_contiguous():
            raise ValueError("grid data must be contiguous")
    for a in arrays:
        if a.dtype != torch.float32:
            raise TypeError(f"grid data must be float32, got {a.dtype}")


_FREE_ARRAYS = ("g_logf", "g_a", "g_p", "g_r", "g_w", "s_logf", "s_a",
                "s_p", "s_r", "s_lnom0", "s_mask")
_FIXED_ARRAYS = ("g_a", "g_p", "g_w")
_Z_ARRAYS = ("g_a", "g_p", "g_w", "n_dz", "n_dz2", "s_a", "s_dz", "s_dz2",
             "s_lnom0", "s_mask")


def _signature(name, data):
    """What kernel ``name``'s C entry point takes for ``data``: (data
    array names, feature count, the ints after ``(W, nfeat)``, the ints
    after the walker tile)."""
    if name.startswith("z"):
        return _Z_ARRAYS, 7, data.shape[1:], ()
    if name.startswith("hier"):
        return _FIXED_ARRAYS, 1 + 3 * data.nfields, (data.nfields,), ()
    if name.startswith("fixed"):
        return _FIXED_ARRAYS, 4, (), ()
    return (_FREE_ARRAYS, 6 + 2 * data.nfields, (data.nfields,),
            (int(bool(data.fcmin)),))


_STREAM_GRID = ("g_logf", "g_a", "g_p", "g_r", "g_w")
_STREAM_SRC = ("s_logf", "s_r", "s_mask")


def _launch_stream(name, feats, data: CudaStreamData, shard=0):
    """Check the inputs and launch streaming kernel ``name`` for shard
    ``shard`` on the current stream of ``feats``' device; returns the
    float64 (W,) value, or (W, 7+2F) rows for the value+gradient
    kernel. Raises on any failure."""
    if feats.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {feats.device}")
    if not 0 <= shard < data.s_logf.shape[0]:
        raise ValueError(f"{name}: row {shard} of the "
                         f"{data.s_logf.shape[0]} shards held")
    from lumfuncmcmc_tpu_torch.ops._build import load_library
    nfeat = 6 + 2 * data.nfields
    arrays = (tuple(getattr(data, a) for a in _STREAM_GRID)
              + tuple(getattr(data, a)[shard] for a in _STREAM_SRC))
    _check_cuda_inputs(feats, nfeat, (data.runs,), arrays)
    lib = load_library()
    grad = name.endswith("_vg")
    w, nruns = feats.shape[0], data.runs.shape[0]
    partial = torch.empty((w, nruns, VG_STREAM_SLOTS if grad else 1),
                          dtype=torch.float64, device=feats.device)
    out = torch.empty((w, 1 + nfeat) if grad else (w,), dtype=torch.float64,
                      device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = getattr(lib, f"{name}_launch")(
        _ptr(feats), w, nfeat, data.nfields, *(_ptr(a) for a in arrays),
        _ptr(data.runs), nruns, data.run_pieces, data.waves[grad],
        int(bool(data.fcmin)),
        _ptr(partial), _ptr(out), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def _tiles(name):
    """The walker tiles of one-launch kernel ``name`` (``VG_TILES``)."""
    fam = name.split("_")[0]
    return VG_TILES[fam if name.endswith("_vg") else f"{fam}_value"]


def _launch_vg(name, feats, data, slots, out_cols):
    """Check the inputs and launch one-launch kernel ``name`` on the
    current stream of ``feats``' device, at the geometry of
    :func:`_vg_geometry`, with a (W, npieces, ``slots``) double scratch
    buffer and the data's tickets (``data`` a :class:`CudaGridData`, or a
    :class:`CudaZData` for the z kernels, whose bands also take their row
    phases, :func:`_z_phases`); returns the float64 (W, ``out_cols``)
    rows, or the (W,) values where ``out_cols`` is None. Raises on any
    failure."""
    if feats.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {feats.device}")
    from lumfuncmcmc_tpu_torch.ops._build import load_library
    names, nfeat, head, flags = _signature(name, data)
    arrays = tuple(getattr(data, a) for a in names)
    tables = tuple(t for _, pieces, segs in data.vg_tables
                   for t in (pieces, segs))
    _check_cuda_inputs(feats, nfeat, tables + (data.vg_tickets,), arrays)
    w = feats.shape[0]
    tile, piece = _vg_geometry(
        {p: t.shape[0] for p, t, _ in data.vg_tables}, w,
        _sm_count(feats.device.index), _tiles(name))
    _, pieces, segs = next(t for t in data.vg_tables if t[0] == piece)
    if name.startswith("z"):
        flags = (_z_phases(data.shape[2], _z_band_rows(data.shape, piece)),)
    lib = load_library()
    partial = torch.empty((w, pieces.shape[0], slots), dtype=torch.float64,
                          device=feats.device)
    out = torch.empty((w,) if out_cols is None else (w, out_cols),
                      dtype=torch.float64, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = getattr(lib, f"{name}_launch")(
        _ptr(feats), w, nfeat, *head, *(_ptr(a) for a in arrays),
        _ptr(pieces), pieces.shape[0], _ptr(segs), segs.shape[0], tile,
        *flags, _ptr(partial), _ptr(data.vg_tickets), _ptr(out),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def _one_launch(slots, out_cols=None):
    """The launch of a one-launch kernel with ``slots`` partial sums and
    ``out_cols(data)`` output columns (a value kernel: none, (W,) out)."""
    def launch(name, feats, data):
        return _launch_vg(name, feats, data, slots,
                          out_cols and out_cols(data))
    return launch


def _wrapper(name, plain, launch, doc):
    """The public wrapper of kernel ``name``: the plain version for a CPU
    tensor; for any other tensor ``launch`` (counted in ``.launches``
    where it launches, and nowhere else) or an error. Arguments after
    ``(feats, data)`` go to both."""

    def kernel(feats, data, *args):
        if feats.device.type == "cpu":
            return plain(feats, data, *args)
        out = launch(name, feats, data, *args)
        kernel.launches += 1
        return out

    kernel.launches = 0
    kernel.__name__ = kernel.__qualname__ = name
    kernel.__doc__ = (f"{doc} CPU tensors take :func:`{plain.__name__}`; "
                      f"CUDA tensors launch the ``{name}`` kernel of "
                      "``csrc/`` or raise.")
    return kernel


free_lnlike = _wrapper(
    "free_lnlike", free_lnlike_reference, _one_launch(1),
    "Free-completeness lnlike, (W, 6+2F) features -> (W,) float64.")
fixed_lnlike = _wrapper(
    "fixed_lnlike", fixed_lnlike_reference, _one_launch(1),
    "Fixed-completeness lnlike without its collapsed ln-term, (W, 4) "
    "features -> (W,) float64.")
free_lnlike_vg = _wrapper(
    "free_lnlike_vg", free_lnlike_vg_reference,
    _one_launch(VG_FREE_SLOTS, lambda data: 7 + 2 * data.nfields),
    "Free-completeness lnlike and its feature gradient, (W, 6+2F) "
    "features -> (W, 7+2F) float64 rows.")
fixed_lnlike_vg = _wrapper(
    "fixed_lnlike_vg", fixed_lnlike_vg_reference,
    _one_launch(VG_HIER_SLOTS, lambda data: 5),
    "Fixed-completeness lnlike without its collapsed ln-term and its "
    "feature gradient, (W, 4) features -> (W, 5) float64 rows.")
z_lnlike = _wrapper(
    "z_lnlike", z_lnlike_reference, _one_launch(1),
    "z-model lnlike, (W, 7) features -> (W,) float64.")
z_lnlike_vg = _wrapper(
    "z_lnlike_vg", z_lnlike_vg_reference,
    _one_launch(VG_Z_SLOTS, lambda data: 8),
    "z-model lnlike and its feature gradient, (W, 7) features -> (W, 8) "
    "float64 rows.")
hier_lnlike = _wrapper(
    "hier_lnlike", hier_lnlike_reference, _one_launch(1),
    "Hierarchical-model lnlike without ``lnrest``, (W, 1+3F) features "
    "-> (W,) float64.")
hier_lnlike_vg = _wrapper(
    "hier_lnlike_vg", hier_lnlike_vg_reference,
    _one_launch(VG_HIER_SLOTS, lambda data: 2 + 3 * data.nfields),
    "Hierarchical-model lnlike without ``lnrest`` and its feature "
    "gradient, (W, 1+3F) features -> (W, 2+3F) float64 rows.")
free_stream_lnlike = _wrapper(
    "free_stream_lnlike", free_stream_lnlike_reference, _launch_stream,
    "Streaming free-completeness lnlike of one shard (``shard``, default "
    "0) without its collapsed source terms, (W, 6+2F) features -> (W,) "
    "float64.")
free_stream_lnlike_vg = _wrapper(
    "free_stream_lnlike_vg", free_stream_lnlike_vg_reference,
    _launch_stream,
    "Streaming free-completeness lnlike of one shard and its feature "
    "gradient, (W, 6+2F) features -> (W, 7+2F) float64 rows.")


class _LnlikeOfFeats(torch.autograd.Function):
    """lnlike of (W, nfeat) features through one value+gradient call;
    the backward is one elementwise multiply by the saved gradient
    columns (``_vg_scalar_from_rows``'s ``custom_vjp``). The features
    arrive as float64 values exact in the data's dtype
    (:func:`_round_st`) and go to the kernel in that dtype; the kernels
    return float64 rows, so value and gradient stay float64."""

    @staticmethod
    def forward(ctx, feats, data, vg):
        rows = vg(feats.to(data.g_a.dtype), data)
        ctx.save_for_backward(rows[:, 1:])
        return rows[:, 0]

    @staticmethod
    def backward(ctx, grad_out):
        (gfeats,) = ctx.saved_tensors
        return gfeats * grad_out[:, None], None, None


# ---------------------------------------------------------------------------
# the public make_* functions
# ---------------------------------------------------------------------------

def _family(ctx: LFContext, layout, model: str, kdtype):
    """The kernel data of ``model`` in ``kdtype``, and its ``(features,
    collapsed, prior test, value kernel, value+gradient kernel)``:
    ``features(thetas)`` gives the rounded float64 rows,
    ``collapsed(feats, thetas)`` the float64 terms the host adds (None:
    the kernel's value is the whole lnlike)."""
    if model == "z":
        data = prepare_cuda_z_data(ctx, layout, dtype=kdtype)
        return data, (_features_z, None, in_box_z, z_lnlike, z_lnlike_vg)
    if model == "hier":
        data = prepare_cuda_h_data(ctx, layout, dtype=kdtype)
        return data, (_features_hier,
                      lambda f, th: _hier_collapsed(f, th, data, layout),
                      in_box, hier_lnlike, hier_lnlike_vg)
    if model != "single":
        raise NotImplementedError(f"model {model!r} has no kernel yet")
    if layout.fix_comp:
        data = prepare_cuda_data(ctx, True, dtype=kdtype)
        return data, (_features, lambda f, th: _fixed_collapsed(f, data),
                      in_box, fixed_lnlike, fixed_lnlike_vg)
    if ctx.lum.shape[0] >= STREAM_MIN_SOURCES:
        data = prepare_cuda_stream_data(ctx, layout.fcmin, dtype=kdtype)
        return data, (_features_stream,
                      lambda f, th: _stream_collapsed(f, data),
                      in_box, free_stream_lnlike, free_stream_lnlike_vg)
    data = prepare_cuda_data(ctx, False, layout.fcmin, dtype=kdtype)
    return data, (_features, None, in_box, free_lnlike, free_lnlike_vg)


def _engine(ctx: LFContext, layout, model: str):
    """What every ``make_*`` function starts from: the kernels' dtype
    (float32 on a CUDA context whatever the context's dtype, as the TPU
    kernels do; the context's on the CPU, where the plain versions run),
    the prior box as tensors (made once: a host tensor per call would
    sync the device) and :func:`_family`'s data and functions. On the card
    the kernel library is built and loaded here, so the first call
    (inside the sampler's timed window) does not pay for it."""
    if ctx.lum.device.type == "cuda":
        from lumfuncmcmc_tpu_torch.ops._build import load_library
        load_library()
    kdtype = torch.float32 if ctx.lum.device.type == "cuda" else ctx.lum.dtype
    lo, hi = layout.bounds_arrays(ctx.lum.dtype, ctx.lum.device)
    data, fns = _family(ctx, layout, model, kdtype)
    return kdtype, lo, hi, data, fns


def _tagged(fn, ctx: LFContext, data):
    """``fn`` with its kernel data (``.data``) and route (``.engine``:
    "cuda" or "plain", "-stream" for the streaming kernels, whose
    ``.stream`` is then ``(sources, source tiles)``)."""
    fn.data = data
    fn.engine = "cuda" if ctx.lum.device.type == "cuda" else "plain"
    if isinstance(data, CudaStreamData):
        fn.engine += "-stream"
        fn.stream = (int(ctx.lum.shape[0]), data.src_off[-1] // CHUNK_CELLS)
    return fn


def _make_lnprob(ctx: LFContext, layout, model: str, grad: bool):
    """The common body of the ``make_*`` lnprob functions (dtypes and
    library loading: :func:`_engine`). Free completeness from
    ``STREAM_MIN_SOURCES`` sources on takes the streaming kernels.

    The kernel's float64 value plus, where the family has them, the
    collapsed ln-terms, both from the same rounded float64 features, are
    summed in float64; then the thetas' dtype and the prior mask: -inf
    outside the prior."""
    kdtype, lo, hi, data, (features, collapsed, inside, value, vg) = \
        _engine(ctx, layout, model)

    def batched(thetas):
        feats = features(thetas, data, layout, kdtype)
        part = (_LnlikeOfFeats.apply(feats, data, vg) if grad
                else value(feats.to(kdtype), data))
        if collapsed is not None:
            part = part + collapsed(feats, thetas)
        lnl = part.to(thetas.dtype)
        return torch.where(inside(thetas, lo, hi), lnl,
                           torch.full_like(lnl, -math.inf))

    return _tagged(batched, ctx, data)


def make_cuda_lnprob(ctx: LFContext, layout: ThetaLayout):
    """(W, D) -> (W,) single-epoch lnprob through the hand-written
    kernels, with the semantics of ``make_lnprob``: the box-prior mask is
    applied outside the kernel, so an out-of-box theta gives -inf.
    Dtypes and library loading: :func:`_make_lnprob`."""
    return _make_lnprob(ctx, layout, "single", grad=False)


def make_cuda_lnprob_z(ctx: LFContext, layout: ThetaLayoutZ):
    """(W, D) -> (W,) z-model lnprob through :func:`z_lnlike`, with the
    semantics of ``make_lnprob_z``: the strict pivot prior masks outside
    the kernel (counterpart of ``make_pallas_lnprob_z``,
    ``pallas_lnlike.py:1518``, without its VMEM gate: one kernel serves
    every catalog size)."""
    return _make_lnprob(ctx, layout, "z", grad=False)


def make_cuda_lnprob_h(ctx: LFContext, layout: ThetaLayoutH):
    """(W, D) -> (W,) hierarchical-model lnprob through
    :func:`hier_lnlike`, with the semantics of ``make_lnprob_h``: the
    per-field grid integrals run in the kernel, the collapsed ln-terms
    and the population hyperprior (``lnrest``) are added on the host in
    float64, and the box prior masks outside the kernel (counterpart of
    ``make_pallas_lnprob_h``, ``pallas_lnlike.py:1574``, without its
    VMEM gate and its fallback)."""
    return _make_lnprob(ctx, layout, "hier", grad=False)


def make_cuda_prior_like(ctx: LFContext, layout, model: str = "single"):
    """``(lnprior_fn, lnlike_fn)``, each (W, D) -> (W,), the split a
    tempered run needs (counterpart of the models' ``_prior_like_fns``,
    ``lumfuncmcmc_tpu/models/model.py:346``): ``lnlike_fn`` is the
    untempered data term through the family's value kernel (the free
    one, or the streaming one from ``STREAM_MIN_SOURCES`` sources on;
    fixed completeness with its collapsed ln-term; the z model; the
    hierarchical per-field terms without the hyperprior), ``lnprior_fn``
    the box prior (0 or -inf) and, for the hierarchical model, the
    population hyperprior, which belongs to the prior measure.

    The features clamp into the box as :func:`_make_lnprob`'s do, so an
    out-of-box row gets a finite ``lnlike_fn`` and ``lnprior_fn`` masks
    it. One ``lnlike_fn`` call is one kernel launch on the card;
    ``lnlike_fn`` carries ``.data``/``.engine`` as the lnprob does."""
    kdtype, lo, hi, data, (features, collapsed, inside, value, _) = \
        _engine(ctx, layout, model)
    if model == "hier":
        def collapsed(f, th):
            return _hier_lnpart_f(f, data).sum(dim=1)

    def lnlike_fn(thetas):
        feats = features(thetas, data, layout, kdtype)
        part = value(feats.to(kdtype), data)
        if collapsed is not None:
            part = part + collapsed(feats, thetas)
        return part.to(thetas.dtype)

    def lnprior_fn(thetas):
        ok = inside(thetas, lo, hi)
        lp = torch.zeros(ok.shape, dtype=thetas.dtype, device=ok.device)
        if model == "hier":
            lp = _hier_hyper_f(thetas, data, layout).sum(dim=1).to(
                thetas.dtype)
        return torch.where(ok, lp, torch.full_like(lp, -math.inf))

    return lnprior_fn, _tagged(lnlike_fn, ctx, data)


def make_cuda_lnprob_and_grad(ctx: LFContext, layout, model: str = "single"):
    """(C, D) -> (C,) lnprob that autograd differentiates through the
    value+gradient kernels — one kernel launch per value-and-gradient
    evaluation (the counterpart of ``make_pallas_lnprob_and_grad``,
    ``pallas_lnlike.py:1771``). ``model`` is "single" (both completeness
    modes), "z" (quadratic pivot evolution, strict pivot prior) or
    "hier" (per-field (L*, phi*) under Gaussian hyperpriors).

    The feature map (with autograd on), one :class:`_LnlikeOfFeats` call,
    then the prior mask: a masked row gives -inf and a gradient of
    exactly 0 (the feature maps' clamps keep its features and their
    gradient finite, so the mask's zero cotangent stays 0).
    """
    return _make_lnprob(ctx, layout, model, grad=True)
