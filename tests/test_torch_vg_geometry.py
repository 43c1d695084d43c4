"""The launch geometry of the one-launch kernels: the value+gradient
kernels ``free_lnlike_vg``, ``fixed_lnlike_vg``, ``hier_lnlike_vg`` and
``z_lnlike_vg``, and the value kernels ``free_lnlike``, ``fixed_lnlike``,
``hier_lnlike`` and ``z_lnlike`` (``ops/cuda_lnlike.py`` ``_vg_tables``,
``_z_vg_tables``, ``_z_phases``, ``_vg_geometry``), on the CPU.

The kernels cannot run here; what surrounds them is Python, so these tests
walk a launch's (piece, walker tile) grid as the kernels index it and hold
it to the data: every cell and every source lies in exactly one block for
each walker, inside its own field; every (row, node) of a z band belongs to
exactly one thread of the kernel's lane mapping; the segment table covers
each field's pieces of each kind once; a launch's tickets fit in the
zeroed buffer. A numpy emulation of the value kernels' summation order
(pieces, walker tiles, row phases, per-thread float32 sums, double
partials and the finish's segment order) holds it to the plain versions.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.models.context import build_context
from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH
from lumfuncmcmc_tpu_torch.models.likelihood import ThetaLayout
from lumfuncmcmc_tpu_torch.models.likelihood_z import ThetaLayoutZ
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

NSM = 132       # an H100's SMs


def _config(size_ln, fam, fcmin=LFConfig.fcmin):
    return LFConfig(min_comp_frac=0.5, size_ln=size_ln,
                    fix_comp=fam != "free", fcmin=fcmin)


@functools.lru_cache(maxsize=None)
def _data(size_ln, fam, dtype=None, fcmin=LFConfig.fcmin):
    """The kernel data of family ``fam`` on a 400-source catalog, in
    ``dtype`` (default: the float64 context's), free completeness with
    ``fcmin``."""
    cfg = _config(size_ln, fam, fcmin)
    cat = apply_completeness_cut(make_catalog(cfg, n_target=400, seed=3),
                                 cfg)
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           field_id=cat["field_id"], device="cpu",
                           dtype=torch.float64)
    if fam == "hier":
        return cl.prepare_cuda_h_data(ctx, ThetaLayoutH.from_config(cfg),
                                      dtype)
    if fam == "z":
        return cl.prepare_cuda_z_data(ctx, ThetaLayoutZ.from_config(cfg),
                                      dtype)
    return cl.prepare_cuda_data(ctx, fam == "fixed", cfg.fcmin, dtype)


def _geometry(data, kind, w):
    npieces = {p: t.shape[0] for p, t, _ in data.vg_tables}
    return cl._vg_geometry(npieces, w, NSM, cl.VG_TILES[kind])


def _cell_pieces(data, pieces, piece):
    """``pieces`` as ``(field, first cell, end cell, is_source)`` over the
    concatenated cells (and sources), with the data's ``(F+1,)`` cell and
    source offsets and each grid piece's most cells: a z band of rows
    ``[r0, r1)`` of field ``f``'s (S_L, S_z) panel is the cells ``[(f S_L
    + r0) S_z, (f S_L + r1) S_z)``, its sources one run of field 0."""
    if not isinstance(data, cl.CudaZData):
        return pieces, data.grid_off, data.src_off, piece
    nf, sl, sz = data.shape
    cells = pieces.copy()
    grid = cells[:, 3] == 0
    cells[grid, 1] = (cells[grid, 0] * sl + cells[grid, 1]) * sz
    cells[grid, 2] = (cells[grid, 0] * sl + cells[grid, 2]) * sz
    return (cells, tuple(f * sl * sz for f in range(nf + 1)),
            (0, data.s_a.numel()), cl._z_band_rows(data.shape, piece) * sz)


@pytest.mark.parametrize("w", [1, 8, 13, 256, 50, 100, 800, 2400, 54320,
                               65535])
@pytest.mark.parametrize("fam", ["free", "hier", "fixed", "free_value",
                                 "fixed_value", "hier_value", "z_value"])
@pytest.mark.parametrize("size_ln", [12, 41])
def test_vg_launch_covers_every_cell_and_source_once(size_ln, fam, w):
    """Block (p, t) runs piece p for walkers [t T, t T + T) (the last tile
    cut at W): over the grid every (walker, cell) and (walker, source)
    pair is covered exactly once (every walker in one tile, every cell and
    source in one piece), each piece within one field and no longer than
    its length; the segments cover the pieces in order, one per field and
    kind; the tickets of the tiles are zero and fit. ``fam`` is a
    value+gradient kernel's family, or a value kernel's (``_value``)."""
    data = _data(size_ln, fam.split("_")[0])
    tile, piece = _geometry(data, fam, w)
    assert tile in cl.VG_TILES[fam] and tile <= w
    assert piece in (cl.VG_Z_PIECES if fam.startswith("z") else
                     cl.VG_PIECES)
    (pieces, segs), = [(p, s) for n, p, s in data.vg_tables if n == piece]
    pieces, segs = pieces.numpy(), segs.numpy()
    cells, grid_off, src_off, most = _cell_pieces(data, pieces, piece)
    ntiles = -(-w // tile)
    assert ntiles <= cl.MAX_ROWS
    walkers = np.zeros(w, int)
    for t in range(ntiles):
        walkers[t * tile:min(w, t * tile + tile)] += 1
    assert (walkers == 1).all()
    for is_src, off in ((0, grid_off), (1, src_off)):
        cover = np.zeros(off[-1], int)
        for f, a, b, src in cells:
            if src != is_src:
                continue
            assert off[f] <= a < b <= off[f + 1]
            assert b - a <= (piece if src else most)
            cover[a:b] += 1
        assert (cover == 1).all()
    if fam in ("hier", "fixed", "fixed_value", "hier_value"):
        assert (pieces[:, 3] == 0).all()
    # segments: consecutive runs of pieces, one per field and kind
    assert segs[0, 1] == 0 and segs[-1, 2] == len(pieces)
    assert (segs[1:, 1] == segs[:-1, 2]).all() and (segs[:, 1]
                                                    < segs[:, 2]).all()
    for f, a, b, src in segs:
        assert (pieces[a:b, 0] == f).all() and (pieces[a:b, 3] == src).all()
    keys = [(f, src) for f, _, _, src in segs]
    assert len(set(keys)) == len(keys)
    nonempty = {(f, 0) for f in range(len(grid_off) - 1)
                if grid_off[f + 1] > grid_off[f]}
    nonempty |= {(f, 1) for f in range(len(src_off) - 1)
                 if src_off[f + 1] > src_off[f]}
    assert set(keys) == nonempty
    tickets = data.vg_tickets
    assert tickets.dtype == torch.int32 and tickets.numel() >= ntiles
    assert not tickets.any()


@pytest.mark.parametrize("piece", [512, 2048, 4096])
def test_vg_pieces_are_near_equal_and_no_longer_than_their_length(piece):
    """Each field's cells (and sources) are cut into ceil(n / piece)
    pieces whose lengths differ by at most one."""
    grid_off, src_off = (0, 10201, 20402, 20403), (0, 379, 379, 1190)
    tab = cl._vg_pieces(grid_off, src_off, piece)
    for is_src, off in ((0, grid_off), (1, src_off)):
        for f in range(len(off) - 1):
            rows = tab[(tab[:, 0] == f) & (tab[:, 3] == is_src)]
            n = off[f + 1] - off[f]
            assert len(rows) == -(-n // piece)
            if n:
                lens = rows[:, 2] - rows[:, 1]
                assert lens.sum() == n and lens.max() <= piece
                assert lens.max() - lens.min() <= 1


# the fits' shapes: pieces per length at trapz-101 free completeness (5
# fields of 10,201 cells and ~380 sources), trapz-201 fixed (5 x 40,401)
# and the z model's bands at trapz-201 (5 x 201 x 201 and 1,672 sources)
NPIECES = {"free": {4096: 20, 2048: 30, 1024: 55, 512: 105},
           "hier": {4096: 50, 2048: 100, 1024: 200, 512: 395},
           "fixed": {4096: 50, 2048: 100, 1024: 200, 512: 395},
           "z": {16384: 16, 8192: 31, 4096: 56, 2048: 106, 1024: 207}}
NPIECES.update(free_value=NPIECES["free"], fixed_value=NPIECES["fixed"],
               z_value=NPIECES["z"], hier_value=NPIECES["hier"])


@pytest.mark.parametrize("fam,w,want", [
    ("free", 1, (1, 512)), ("free", 8, (1, 2048)), ("free", 256, (2, 4096)),
    ("hier", 1, (1, 1024)), ("hier", 8, (2, 4096)), ("hier", 256, (4, 4096)),
    ("fixed", 1, (1, 1024)), ("fixed", 8, (4, 2048)),
    ("fixed", 256, (4, 4096)),
    ("z", 1, (1, 1024)), ("z", 8, (2, 4096)), ("z", 256, (4, 16384)),
    ("hier_value", 1, (1, 1024)), ("hier_value", 8, (4, 2048)),
    ("hier_value", 13, (4, 4096)), ("hier_value", 50, (8, 4096)),
    ("hier_value", 100, (8, 4096)), ("hier_value", 2400, (8, 4096)),
    ("z_value", 1, (1, 1024)), ("z_value", 8, (2, 4096)),
    ("z_value", 13, (2, 8192)), ("z_value", 50, (8, 8192)),
    ("z_value", 100, (8, 16384)),
    ("z_value", 2400, (8, 16384)),
    ("free_value", 1, (1, 512)), ("free_value", 8, (1, 2048)),
    ("free_value", 13, (1, 4096)), ("free_value", 50, (4, 4096)),
    ("free_value", 100, (4, 4096)), ("free_value", 1200, (4, 4096)),
    ("free_value", 2400, (4, 4096)),
    ("fixed_value", 1, (1, 1024)), ("fixed_value", 8, (4, 2048)),
    ("fixed_value", 13, (4, 4096)), ("fixed_value", 50, (8, 4096)),
    ("fixed_value", 100, (8, 4096)), ("fixed_value", 1600, (8, 4096)),
    ("fixed_value", 2400, (8, 4096)),
    # the evidence ladder: a half-step of 16 rungs x 100 walkers / 2, and
    # the lnlike recompute's chunks of MAX_ROWS rows and a remainder
    ("free_value", 800, (4, 4096)), ("free_value", 54320, (4, 4096)),
    ("free_value", 65535, (4, 4096)),
    ("fixed_value", 800, (8, 4096)), ("fixed_value", 65535, (8, 4096)),
    ("z_value", 800, (8, 16384)), ("z_value", 65535, (8, 16384)),
    ("hier_value", 800, (8, 4096)), ("hier_value", 65535, (8, 4096))])
def test_vg_geometry_at_the_fits_shapes(fam, w, want):
    """The rule's choices on an H100's 132 SMs at the NUTS path's batches
    (value+gradient kernels: 1 chain, 8, 256) and the value kernels'
    (``_value``: the NUTS start guard's 8 chains, 13, a stretch half-step
    of 50, 100, the NUTS recompute's samples x 8 chains: 1,200 free, 1,600
    fixed, 2,400 z and hier; the evidence ladder's half-step of 800 rows
    and its recompute's chunks of up to 65,535): at least 1.5 blocks per
    SM where any grid has
    them, with the most work a block, at equal work the kernel's first
    tile; else tile 1 and the shortest piece."""
    got = cl._vg_geometry(NPIECES[fam], w, NSM, cl.VG_TILES[fam])
    assert got == want
    tile, piece = got
    blocks = -(-w // tile) * NPIECES[fam][piece]
    assert 2 * blocks >= 3 * NSM or got == (1, min(NPIECES[fam]))


@pytest.mark.parametrize("size_ln", [12, 41, 300])
def test_z_vg_launch_covers_every_cell_source_and_lane_once(size_ln):
    """The z kernels' tables at every band length, on grids of 12, 41
    and 300 (more than a block's threads) z nodes: the bands cut each
    field's rows, and the sources, into pieces that cover them once, each
    band inside its field and no longer than ``_z_band_rows``; in every
    band the kernel's lane mapping (pair ``q < S_z G`` of thread ``q mod
    THREADS``: node ``q mod S_z``, rows ``r0 + q // S_z + k G``) gives each
    (row, node) to exactly one thread; one segment a field and one for the
    sources; every walker in exactly one tile of each tile size of either
    kernel; the tickets zero and enough for the largest batch."""
    data = _data(size_ln, "z")
    nf, sl, sz = data.shape
    nsrc = data.s_a.numel()
    assert [p for p, _, _ in data.vg_tables] == list(cl.VG_Z_PIECES)
    for piece, pieces, segs in data.vg_tables:
        pieces, segs = pieces.numpy(), segs.numpy()
        rows = cl._z_band_rows(data.shape, piece)
        g = cl._z_phases(sz, rows)
        assert 1 <= g <= rows
        grid = pieces[pieces[:, 3] == 0]
        src = pieces[pieces[:, 3] == 1]
        assert len(grid) + len(src) == len(pieces)
        cover = np.zeros((nf, sl), int)
        for f, a, b, _ in grid:
            assert 0 <= f < nf and 0 <= a < b <= sl and b - a <= rows
            cover[f, a:b] += 1
        assert (cover == 1).all()
        cover = np.zeros(nsrc, int)
        for f, a, b, _ in src:
            assert f == 0 and 0 <= a < b <= nsrc and b - a <= piece
            cover[a:b] += 1
        assert (cover == 1).all()
        for n in set(grid[:, 2] - grid[:, 1]):
            owner = np.full((n, sz), -1)
            for q in range(sz * g):
                rr = np.arange(q // sz, n, g)
                assert (owner[rr, q % sz] == -1).all()
                owner[rr, q % sz] = q % cl.THREADS
            assert (owner >= 0).all()
            if sz * g >= cl.THREADS and n == rows:
                # every lane has cells
                assert len(np.unique(owner)) == cl.THREADS
        keys = [(f, s) for f, _, _, s in segs]
        assert keys == [(f, 0) for f in range(nf)] + [(0, 1)] * bool(nsrc)
        assert segs[0, 1] == 0 and segs[-1, 2] == len(pieces)
        assert (segs[1:, 1] == segs[:-1, 2]).all()
    for tile in set(cl.VG_TILES["z"] + cl.VG_TILES["z_value"]):
        for w in (1, 8, 13, 50, 100, 256, 2400):
            seen = np.zeros(w, int)
            for t in range(-(-w // tile)):
                seen[t * tile:min(w, t * tile + tile)] += 1
            assert (seen == 1).all()
    tickets = data.vg_tickets
    assert tickets.dtype == torch.int32
    assert tickets.numel() >= cl.MAX_ROWS and not tickets.any()


@pytest.mark.parametrize("s_z,rows,want", [
    (201, 34, 5), (201, 67, 5), (201, 5, 1), (32, 32, 8), (12, 12, 12),
    (41, 21, 6), (300, 3, 1)])
def test_z_phases_keep_the_lanes_busy(s_z, rows, want):
    """The row phases at the shapes the fits and the tests give: at 201
    nodes and bands of 34 or 67 rows 5 phases (1,005 pairs, 4 a thread,
    where one node a thread leaves 55 of 256 lanes idle), at 32 nodes 8
    (256 pairs), at 12 the band's every row; where a band holds a few rows
    one phase."""
    assert cl._z_phases(s_z, rows) == want


def _vg_smem(tile, nseg, k):
    """``vg_smem`` of ``csrc/vg_ticket.cuh``: the staged segment table
    (16-byte int4 rows), then ``tile`` walkers' ``k`` double segment
    sums."""
    return 16 * nseg + 8 * tile * nseg * k


def test_z_node_quantities_are_16_byte_aligned():
    """Both z kernels keep their band's node quantities, float4s, in
    dynamic shared memory after ``vg_smem``'s bytes; at one slot
    (``z_lnlike``) and one walker an odd segment count (an even number of
    fields with sources) ends those 8 bytes past a multiple of 16. Both
    kernels and ``z_smem`` take the node array's offset from
    ``z_node_off``, which rounds it up to 16 bytes at every tile and
    segment count."""
    with open(Path(cl.__file__).parent.parent / "csrc" / "lnlike_z.cu") as fh:
        src = fh.read()
    assert "return (vg_smem(tile, nseg, k) + 15) & ~(size_t)15;" in src
    for k in ("1", "Z_SLOTS"):
        assert f"node = (float4*)(smem + z_node_off(T, nseg, {k}));" in src
    assert "return z_node_off(tile, nseg, k) + (size_t)s_z" in src
    assert _vg_smem(1, 5, 1) % 16 == 8
    for tile in set(cl.VG_TILES["z"] + cl.VG_TILES["z_value"]):
        for k in (1, cl.VG_Z_SLOTS):
            for nseg in range(1, 18):
                off = (_vg_smem(tile, nseg, k) + 15) & ~15
                assert off % 16 == 0 and 0 <= off - _vg_smem(tile, nseg,
                                                               k) < 16


def _value_feats(size_ln, fam, w, seed, fcmin=LFConfig.fcmin):
    """``w`` float32 feature rows of kernel family ``fam`` (``free``,
    ``fixed``, ``z`` or ``hier``) for thetas drawn by numpy within ~1% of
    the box width of the catalog's true parameters, where a fit spends its
    steps (far from them a few cells carry the whole integral), and their
    float32 kernel data, as the kernels take them."""
    cfg = _config(size_ln, fam, fcmin)
    layout = {"z": ThetaLayoutZ, "hier": ThetaLayoutH}.get(
        fam, ThetaLayout).from_config(cfg)
    lo, hi = (x.numpy() for x in layout.bounds_arrays(torch.float64, "cpu"))
    truth = {"L": cfg.Lstar, "m": cfg.Lstar, "p": cfg.phistar,
             "s": cfg.sch_al}
    named = {"mu_p": cfg.phistar, "sig_L": 0.3, "sig_p": 0.5,
             "alpha": cfg.alpha}
    named.update({f"Flim_{i}": v for i, v in enumerate(cfg.Flim)})
    center = np.array([named[n] if n in named else truth[n[0]]
                       for n in layout.names])
    rng = np.random.default_rng(seed)
    th = torch.as_tensor(center + 0.01 * (hi - lo) * rng.standard_normal(
        (w, layout.ndim)))
    data = _data(size_ln, fam, torch.float32, fcmin)
    features = {"z": cl._features_z, "hier": cl._features_hier}.get(
        fam, cl._features)
    return features(th, data, layout, torch.float32).float(), data


def _finish(partial, segs):
    """The tile's last block: each walker's partials summed per segment,
    the segments then added in order, in double."""
    out = np.zeros(partial.shape[0])
    for _, a, b, _ in segs:
        out = out + partial[:, a:b].sum(axis=1)
    return out


def _emulate_pieces(f, data, tile, piece, term):
    """The one-launch value kernels' summation order in numpy: block (p,
    t) gives each of its THREADS threads the cells (or sources) ``a + tid,
    a + tid + THREADS, ...`` of piece p, whose float32 terms ``term(th,
    field, is_source, index)`` for the walkers ``th`` of tile t (rows past
    W repeat walker 0) it sums in float32; the block's sums and the
    partials are double. Returns the (W, npieces) partials and the
    segment table."""
    (pieces, segs), = [(p.numpy(), s.numpy()) for n, p, s in data.vg_tables
                       if n == piece]
    w = f.shape[0]
    partial = np.zeros((w, len(pieces)))
    for k, (fld, a, b, is_src) in enumerate(pieces):
        idx = a + np.arange(-(-(b - a) // cl.THREADS) * cl.THREADS).reshape(
            -1, cl.THREADS)
        for w0 in range(0, w, tile):
            nw = min(tile, w - w0)
            th = f[[w0 + (j if j < nw else 0) for j in range(tile)]]
            acc = np.zeros((tile, cl.THREADS), np.float32)
            for trip in idx:
                e = term(th, fld, is_src, np.minimum(trip, b - 1))
                acc = np.where(trip < b, acc + e, acc)
            partial[w0:w0 + nw, k] = acc.astype(np.float64).sum(1)[:nw]
    return partial, segs


def _emulate_fixed_cells(f, data, tile, piece, shared):
    """``hier_lnlike``'s (or, ``shared``, ``fixed_lnlike``'s: every field
    reads the row ``[c, aA, lA, t1]``) summation order: a thread's cells
    ``exp(c + aA (a - lA) - P t1) w`` in float32, double partials; the
    finish adds them segment by segment and negates."""
    ga, gp, gw = (x.numpy() for x in (data.g_a, data.g_p, data.g_w))

    def term(th, fld, _, i):
        if shared:
            cg, aA, lA, t1 = (th[:, k:k + 1] for k in range(4))
        else:
            aA = th[:, :1]
            cg, lA, t1 = (th[:, 1 + 3 * fld + k:2 + 3 * fld + k]
                          for k in range(3))
        return np.exp(cg + aA * (ga[i] - lA) - gp[i] * t1) * gw[i]
    return -_finish(*_emulate_pieces(f, data, tile, piece, term))


def _emulate_hier_lnlike(f, data, tile, piece):
    return _emulate_fixed_cells(f, data, tile, piece, shared=False)


def _emulate_fixed_lnlike(f, data, tile, piece):
    return _emulate_fixed_cells(f, data, tile, piece, shared=True)


def _emulate_free_lnlike(f, data, tile, piece):
    """``free_lnlike``'s summation order in numpy: a grid piece's terms
    ``exp(c_g + aA (a - lA) - P t1 + ln fc) w`` and a source piece's
    masked ``c_s + aA (a - lA) - P t1 + ln Omega0 + ln fc``, float32 per
    thread, double partials; the finish adds each segment's, grid
    segments negated, in segment order. (ln fc takes numpy's log and
    divide, where the kernel takes the SFU's: the card's tests hold
    those to the plain version.)"""
    nf = data.nfields
    g = {k: getattr(data, f"g_{k}").numpy() for k in ("logf", "a", "p", "r",
                                                      "w")}
    s = {k: getattr(data, f"s_{k}").numpy() for k in ("logf", "a", "p", "r",
                                                      "lnom0", "mask")}
    one = np.float32(1.0)

    def term(th, fld, is_src, i):
        c0 = th[:, 1 if is_src else 0][:, None]
        aA, lA, t1, ac = (th[:, k:k + 1] for k in range(2, 6))
        lf50, t2 = th[:, 6 + fld][:, None], th[:, 6 + nf + fld][:, None]
        d = s if is_src else g
        x = ac * (d["logf"][i] - lf50)
        fc = np.maximum(np.float32(0.5) + np.float32(0.5) * x
                        * (one / np.sqrt(one + x * x)), np.float32(1e-30))
        lnfc = np.log(fc)
        if data.fcmin:
            lnfc = lnfc / (one - np.exp(-(d["r"][i] * t2)))
        part = c0 + aA * (d["a"][i] - lA) - d["p"][i] * t1
        if is_src:
            return np.where(s["mask"][i] > 0, part + s["lnom0"][i] + lnfc,
                            np.float32(0.0))
        return np.exp(part + lnfc) * g["w"][i]
    partial, segs = _emulate_pieces(f, data, tile, piece, term)
    out = np.zeros(partial.shape[0])
    for _, a, b, is_src in segs:
        out = out + (1.0 if is_src else -1.0) * partial[:, a:b].sum(axis=1)
    return out


def _emulate_z_lnlike(f, data, tile, piece):
    """``z_lnlike``'s summation order in numpy: a band's node quantities
    formed in double and rounded once (``z_node``), its (node, phase) pairs
    each a float32 Kahan pair per walker down its rows ``r0 + phase + k
    G``, the columns negated into the double value; a source piece's terms
    float32, summed in double; double partials and the finish's segment
    order."""
    (pieces, segs), = [(p.numpy(), s.numpy()) for n, p, s in data.vg_tables
                       if n == piece]
    nf, sl, sz = data.shape
    g = cl._z_phases(sz, cl._z_band_rows(data.shape, piece))
    ga, gp, gw, ndz, ndz2, sa, sdz, sdz2, som, smask = (
        x.numpy() for x in (data.g_a, data.g_p, data.g_w, data.n_dz,
                            data.n_dz2, data.s_a, data.s_dz, data.s_dz2,
                            data.s_lnom0, data.s_mask))
    w = f.shape[0]
    partial = np.zeros((w, len(pieces)))
    q = np.arange(sz * g)
    node, phase = q % sz, q // sz
    for k, (fld, a, b, is_src) in enumerate(pieces):
        for w0 in range(0, w, tile):
            nw = min(tile, w - w0)
            th = f[[w0 + (j if j < nw else 0) for j in range(tile)]]
            t = [th[:, i:i + 1] for i in range(7)]
            if is_src:
                x = sa[a:b] - (t[3] * sdz2[a:b] + t[4] * sdz[a:b] + t[5])
                c = (t[0] * sdz2[a:b] + t[1] * sdz[a:b] + t[2] + t[6] * x
                     - np.exp(x) + som[a:b])
                val = np.where(smask[a:b] > 0, c, 0).astype(np.float64)
                partial[w0:w0 + nw, k] = val.sum(1)[:nw]
                continue
            td = [x.astype(np.float64) for x in t]
            dz = ndz[fld * sz + node].astype(np.float64)
            dz2 = ndz2[fld * sz + node].astype(np.float64)
            lq = td[3] * dz2 + td[4] * dz + td[5]
            base = td[0] * dz2 + td[1] * dz + td[2] - td[6] * lq
            t1 = np.exp(-lq.astype(np.float32))
            hi = base.astype(np.float32)
            lo = (base - hi).astype(np.float32)
            col = np.zeros((tile, len(q)), np.float32)
            comp = np.zeros_like(col)
            for r in range(a, b, g):
                row = r + phase
                i = (fld * sl + np.minimum(row, b - 1)) * sz + node
                e = np.exp(hi + ((t[6] * ga[i] - gp[i] * t1) + lo)) * gw[i]
                y = e - comp
                s = col + y
                live = row < b
                comp = np.where(live, (s - col) - y, comp)
                col = np.where(live, s, col)
            val = -(col.astype(np.float64) - comp.astype(np.float64))
            partial[w0:w0 + nw, k] = val.sum(1)[:nw]
    return _finish(partial, segs)


@pytest.mark.parametrize("fam,fcmin", [
    ("z", 0.1), ("hier", 0.1), ("fixed", 0.1), ("free", 0.1), ("free", 0.0)])
@pytest.mark.parametrize("size_ln", [12, 41])
def test_value_kernels_summation_order_matches_the_plain_versions(
        size_ln, fam, fcmin):
    """A numpy emulation of the one-launch value kernels' order of
    summation, at the rule's geometry for W = 13 and at tiles of 8 on the
    longest pieces, stays within 1e-6 of ``z_lnlike_reference`` /
    ``hier_lnlike_reference`` / ``fixed_lnlike_reference`` /
    ``free_lnlike_reference`` (the same float32 terms, summed in float64;
    free completeness with ``fcmin`` on and off) on seeded thetas: the
    per-thread float32 sums cost no more than that."""
    f, data = _value_feats(size_ln, fam, 13, seed=size_ln, fcmin=fcmin)
    assert fam != "free" or data.fcmin == fcmin
    ref = getattr(cl, f"{fam}_lnlike_reference")(f, data).numpy()
    emulate = {"z": _emulate_z_lnlike, "hier": _emulate_hier_lnlike,
               "fixed": _emulate_fixed_lnlike,
               "free": _emulate_free_lnlike}[fam]
    longest = max(p for p, _, _ in data.vg_tables)
    for tile, piece in (_geometry(data, f"{fam}_value", 13), (8, longest)):
        got = emulate(f.numpy(), data, tile, piece)
        np.testing.assert_allclose(got, ref, rtol=1e-6)
