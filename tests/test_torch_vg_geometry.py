"""The launch geometry of the one-launch value+gradient kernels
``free_lnlike_vg``, ``fixed_lnlike_vg``, ``hier_lnlike_vg`` and
``z_lnlike_vg`` (``ops/cuda_lnlike.py`` ``_vg_tables``, ``_z_vg_tables``,
``_z_phases``, ``_vg_geometry``), on the CPU.

The kernels cannot run here; what surrounds them is Python, so these tests
walk a launch's (piece, walker tile) grid as the kernels index it and hold
it to the data: every cell and every source lies in exactly one block for
each walker, inside its own field; every (row, node) of a z band belongs to
exactly one thread of the kernel's lane mapping; the segment table covers
each field's pieces of each kind once; a launch's tickets fit in the
zeroed buffer.
"""

import functools

import numpy as np
import pytest
import torch

from lumfuncmcmc_tpu_torch import LFConfig
from lumfuncmcmc_tpu_torch.models.context import build_context
from lumfuncmcmc_tpu_torch.models.hierarchical import ThetaLayoutH
from lumfuncmcmc_tpu_torch.models.likelihood_z import ThetaLayoutZ
from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
from lumfuncmcmc_tpu_torch.utils.synth import (
    apply_completeness_cut, make_catalog)

NSM = 132       # an H100's SMs


@functools.lru_cache(maxsize=None)
def _data(size_ln, fam):
    cfg = LFConfig(min_comp_frac=0.5, size_ln=size_ln,
                   fix_comp=fam != "free")
    cat = apply_completeness_cut(make_catalog(cfg, n_target=400, seed=3),
                                 cfg)
    _, ctx = build_context(cfg, z=cat["z"], flux=cat["flux"],
                           field_id=cat["field_id"], device="cpu",
                           dtype=torch.float64)
    if fam == "hier":
        return cl.prepare_cuda_h_data(ctx, ThetaLayoutH.from_config(cfg))
    if fam == "z":
        return cl.prepare_cuda_z_data(ctx, ThetaLayoutZ.from_config(cfg))
    return cl.prepare_cuda_data(ctx, fam == "fixed", cfg.fcmin)


def _geometry(data, fam, w):
    npieces = {p: t.shape[0] for p, t, _ in data.vg_tables}
    return cl._vg_geometry(npieces, w, NSM, cl.VG_TILES[fam])


@pytest.mark.parametrize("w", [1, 8, 13, 256])
@pytest.mark.parametrize("fam", ["free", "hier", "fixed"])
@pytest.mark.parametrize("size_ln", [12, 41])
def test_vg_launch_covers_every_cell_and_source_once(size_ln, fam, w):
    """Block (p, t) runs piece p for walkers [t T, t T + T) (the last tile
    cut at W): over the grid every (walker, cell) and (walker, source)
    pair is covered exactly once, each piece within one field and no
    longer than its length; the segments cover the pieces in order, one
    per field and kind; the tickets of the tiles are zero and fit."""
    data = _data(size_ln, fam)
    tile, piece = _geometry(data, fam, w)
    assert tile in cl.VG_TILES[fam] and piece in cl.VG_PIECES
    assert tile <= w
    (pieces, segs), = [(p, s) for n, p, s in data.vg_tables if n == piece]
    pieces, segs = pieces.numpy(), segs.numpy()
    ntiles = -(-w // tile)
    for is_src, off in ((0, data.grid_off), (1, data.src_off)):
        cover = np.zeros((w, off[-1]), int)
        for f, a, b, src in pieces:
            if src != is_src:
                continue
            assert off[f] <= a < b <= off[f + 1] and b - a <= piece
            for t in range(ntiles):
                cover[t * tile:min(w, t * tile + tile), a:b] += 1
        assert (cover == 1).all()
    if fam != "free":
        assert (pieces[:, 3] == 0).all()
    # segments: consecutive runs of pieces, one per field and kind
    assert segs[0, 1] == 0 and segs[-1, 2] == len(pieces)
    assert (segs[1:, 1] == segs[:-1, 2]).all() and (segs[:, 1]
                                                    < segs[:, 2]).all()
    for f, a, b, src in segs:
        assert (pieces[a:b, 0] == f).all() and (pieces[a:b, 3] == src).all()
    keys = [(f, src) for f, _, _, src in segs]
    assert len(set(keys)) == len(keys)
    nonempty = {(f, 0) for f in range(data.nfields)
                if data.grid_off[f + 1] > data.grid_off[f]}
    nonempty |= {(f, 1) for f in range(data.nfields)
                 if data.src_off[f + 1] > data.src_off[f]}
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


@pytest.mark.parametrize("fam,w,want", [
    ("free", 1, (1, 512)), ("free", 8, (1, 2048)), ("free", 256, (2, 4096)),
    ("hier", 1, (1, 1024)), ("hier", 8, (2, 4096)), ("hier", 256, (4, 4096)),
    ("fixed", 1, (1, 1024)), ("fixed", 8, (4, 2048)),
    ("fixed", 256, (4, 4096)),
    ("z", 1, (1, 1024)), ("z", 8, (2, 4096)), ("z", 256, (4, 16384))])
def test_vg_geometry_at_the_fits_shapes(fam, w, want):
    """The rule's choices at the NUTS path's batches on an H100's 132 SMs:
    at least 1.5 blocks per SM where any grid has them, with the most work
    a block, at equal work the family's first tile; else tile 1 and the
    shortest piece."""
    got = cl._vg_geometry(NPIECES[fam], w, NSM, cl.VG_TILES[fam])
    assert got == want
    tile, piece = got
    blocks = -(-w // tile) * NPIECES[fam][piece]
    assert 2 * blocks >= 3 * NSM or got == (1, min(NPIECES[fam]))


@pytest.mark.parametrize("size_ln", [12, 41, 300])
def test_z_vg_launch_covers_every_cell_source_and_lane_once(size_ln):
    """``z_lnlike_vg``'s tables at every band length, on grids of 12, 41
    and 300 (more than a block's threads) z nodes: the bands cut each
    field's rows, and the sources, into pieces that cover them once, each
    band inside its field and no longer than ``_z_band_rows``; in every
    band the kernel's lane mapping (pair ``q < S_z G`` of thread ``q mod
    THREADS``: node ``q mod S_z``, rows ``r0 + q // S_z + k G``) gives each
    (row, node) to exactly one thread; one segment a field and one for the
    sources; every walker in exactly one tile of each tile size; the
    tickets zero and enough for the largest batch."""
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
    for tile in cl.VG_TILES["z"]:
        for w in (1, 8, 13, 256):
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
