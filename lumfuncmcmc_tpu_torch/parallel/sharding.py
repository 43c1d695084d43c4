"""The stretch-family routes on the grid (port of the stretch half of
``lumfuncmcmc_tpu/parallel/sharding.py``).

The likelihood factorizes as

    lnprob(theta) = lnprior(theta)
                  + [ per-source reduction  (split over the source ranks) ]
                  - [ per-field grid integral (replicated; small) ]

and the walkers are independent, so the batched lnprob splits a (W, D)
batch over the walker ranks and the per-source arrays over the source
ranks. JAX's ``shard_map`` is one program over the mesh; here every rank
runs the whole sampler, holds the whole ensemble state (W x D, a few KB)
and draws the same randoms from the same generator (Philox on every
card), and the lnprob is the only place the ranks meet: each walker rank
evaluates its slice of the batch (padded to a multiple of the walker
ranks, :func:`_pad_walkers`), a source-sharded grid first sums the
per-source part over its source group with one ``all_reduce``, and one
``all_gather`` over the walker group gives every rank the whole batch's
values. Every rank then takes the same accepts, so the chain is the
meshless chain given equal lnprob values (in float64 on the CPU, bit for
bit).

Whole ensembles (:func:`run_stretch_ensembles_sharded`) and whole ladder
rungs (:func:`run_tempered_sharded`,
:func:`run_parallel_tempering_sharded`) go one or more to a rank: every
rank draws the randoms of all of them, as the meshless run does, and runs
its own rows, so the grid reproduces the meshless run.

NUTS chains go in blocks to the ranks of an axis (:func:`run_nuts_sharded`:
every rank of the grid for the per-rank replicas, the walker ranks for the
pooled and streaming routes), each rank running the meshless sampler on its
block with every transition's numbers drawn for the whole batch and its
rows kept (``samplers/nuts.py block_draw``). The streaming route
(:func:`run_nuts_stream_sharded`) splits the catalog over the source ranks
inside the value+gradient: one ``all_reduce`` of the shard's value and
feature gradient a call (:func:`make_cuda_lnprob_and_grad_stream_sharded`),
so the ranks of a source group hold the same chains, get the same bits and
leave every leapfrog loop together. The state a run returns is per chain,
so it regroups onto any grid (elastic checkpoints).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from lumfuncmcmc_tpu_torch.models.context import LFContext
from lumfuncmcmc_tpu_torch.parallel.distributed import (
    all_gather_rows, all_reduce_sum)

# context fields carrying a leading source axis
_SRC_FIELDS = ("lum", "zsrc", "logf_src", "omega0_src", "ln_om_src",
               "field_id", "src_mask")


def pad_sources(ctx: LFContext, multiple: int) -> LFContext:
    """Pad the source axis to a multiple of the grid's source axis.

    Padded rows carry ``src_mask = 0`` and replicate a real row's values,
    so the masked likelihood is unchanged (no -inf/NaN from fabricated
    inputs)."""
    n = ctx.lum.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return ctx
    pad = target - n
    updates = {}
    for f in _SRC_FIELDS:
        arr = getattr(ctx, f)
        fill = torch.zeros_like(arr[0:1]) if f == "src_mask" else arr[0:1]
        updates[f] = torch.cat([arr, fill.repeat(pad)])
    return dataclasses.replace(ctx, **updates)


def source_shard(ctx: LFContext, nshards: int, k: int) -> LFContext:
    """Shard ``k`` of ``nshards`` of the context's sources: the k-th
    contiguous block of the padded source axis (``shard_map``'s split)."""
    ctx = pad_sources(ctx, nshards)
    blk = ctx.lum.shape[0] // nshards
    at = slice(k * blk, (k + 1) * blk)
    return dataclasses.replace(
        ctx, **{f: getattr(ctx, f)[at].clone() for f in _SRC_FIELDS})


def _chain_blk(nchains: int, shards: int, what: str) -> int:
    """Chains (ensembles, rungs) per rank, with the run paths' explicit
    error when ``shards`` does not divide ``nchains``."""
    if nchains % shards:
        raise ValueError(
            f"{what} count {nchains} must be a multiple of the grid's "
            f"{shards} ranks (whole {what}s per rank)")
    return nchains // shards


def _pad_walkers(thetas, multiple: int):
    """Pad a (W, D) walker batch to a multiple of the sharded walker
    axis by repeating row 0 (an always-in-bounds real theta, so padded
    rows never produce NaN work). Returns ``(padded, W)``; callers slice
    outputs back to ``[:W]``, so a padded row reaches no accept."""
    w = thetas.shape[0]
    wpad = -(-w // multiple) * multiple
    if wpad != w:
        thetas = torch.cat([thetas,
                            thetas[:1].expand(wpad - w, thetas.shape[1])])
    return thetas, w


def _walker_sharded(local, nshards: int, index: int, group):
    """(W, D) -> (W,): ``local`` over this rank's slice of the padded
    batch, the slices gathered over ``group`` (``nshards`` ranks, this
    one ``index``)."""
    def batch(thetas):
        padded, w = _pad_walkers(thetas, nshards)
        blk = padded.shape[0] // nshards
        out = local(padded[index * blk:(index + 1) * blk])
        return all_gather_rows(out, group)[:w]
    return batch


def _source_parts(ctx, layout, model, collapse, exact_bounds,
                  min_comp_frac, lh, lum_floor):
    """``(parts(theta, ctx) -> (lnpart, fullint), lnprior)`` of the
    sharded eager engine."""
    from lumfuncmcmc_tpu_torch.models import likelihood as lk
    from lumfuncmcmc_tpu_torch.models import likelihood_z as lz
    if model == "z":
        return ((lambda th, c: lz.lnlike_z_parts(th, c, layout)),
                lambda th: lz.lnprior_z(th, layout))
    if exact_bounds:
        def parts(th, c):
            return lk.lnlike_exact_bounds_parts(th, c, layout, min_comp_frac,
                                                lum_floor, lh)
    else:
        def parts(th, c):
            return lk.lnlike_single_epoch_parts(th, c, layout,
                                                collapse=collapse)
    return parts, lambda th: lk.lnprior(th, layout)


def make_lnprob_sharded(ctx: LFContext, layout, grid, model="single",
                        collapse=True, exact_bounds=False,
                        min_comp_frac=0.5, lh=46.0):
    """(W, D) -> (W,) batched lnprob of the eager engine on ``grid``.

    ``model``: "single" (ThetaLayout), "z" (ThetaLayoutZ) or "hier".
    ``exact_bounds`` selects the theta-exact integration-bound likelihood
    of the free-completeness single-epoch model. Any batch size is
    accepted (padded to a multiple of the walker ranks and sliced back).
    A grid whose sources are not split evaluates the meshless lnprob on
    its walker slice; a source-split one evaluates ``(lnpart, fullint)``
    on its source block, sums ``lnpart`` over the source group and
    subtracts the integral once. The collapsed ln-term is off there
    (``collapse``: whole-catalog sums), and the hierarchical model is
    never source-split: it reads only per-field catalog sums, and summing
    its data term over the source ranks would count it once a rank.
    """
    from lumfuncmcmc_tpu_torch.models.hierarchical import make_lnprob_h
    from lumfuncmcmc_tpu_torch.models.likelihood import make_lnprob
    from lumfuncmcmc_tpu_torch.models.likelihood_z import make_lnprob_z
    if model not in ("single", "z", "hier"):
        raise ValueError(f"unknown model {model!r}")
    shard_sources = grid.n_sources > 1 and model != "hier"
    if not shard_sources:
        if model == "single":
            local = make_lnprob(ctx, layout, collapse=collapse,
                                exact_bounds=exact_bounds,
                                min_comp_frac=min_comp_frac, lh=lh)
        else:
            local = {"z": make_lnprob_z, "hier": make_lnprob_h}[model](
                ctx, layout)
        batch = _walker_sharded(local, grid.n_walkers, grid.walker_index,
                                grid.walker_group)
        batch.source_shards = 1
        return batch
    # the floor is the whole catalog's faintest source, not a block's
    lum_floor = float(ctx.lum.min()) if exact_bounds else None
    parts, lnprior_fn = _source_parts(ctx, layout, model, False,
                                      exact_bounds, min_comp_frac, lh,
                                      lum_floor)
    block = source_shard(ctx, grid.n_sources, grid.source_index)

    def local(th):
        # the integral is a function of replicated grid arrays: every
        # source rank holds the same value, so it is subtracted once,
        # after the sum of the source parts
        lnpart, fullint = parts(th, block)
        lnl = all_reduce_sum(lnpart, grid.source_group) - fullint
        lp = lnprior_fn(th)
        return torch.where(torch.isfinite(lp), lp + lnl,
                           torch.full_like(lnl, -math.inf))

    batch = _walker_sharded(local, grid.n_walkers, grid.walker_index,
                            grid.walker_group)
    batch.source_shards = grid.n_sources
    return batch


def make_cuda_lnprob_sharded(ctx: LFContext, layout, grid, model="single"):
    """The family's value-kernel lnprob (``make_cuda_lnprob``,
    ``_z``, ``_h``: ``free_lnlike``, ``fixed_lnlike``, ``z_lnlike``,
    ``hier_lnlike``; on the CPU their plain versions) on this rank's
    walker slice, with the sources replicated: the walker batch is split
    over every rank of the grid, both axes (counterpart of
    ``make_pallas_lnprob_sharded``, ``sharding.py:881``: a catalog whose
    kernel data one card holds spends the source axis on more walker
    parallelism rather than on replicated work). Carries the meshless
    function's ``.engine``/``.data``/``.stream``."""
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    make = {"single": cl.make_cuda_lnprob, "z": cl.make_cuda_lnprob_z,
            "hier": cl.make_cuda_lnprob_h}[model]
    inner = make(ctx, layout)
    batch = _walker_sharded(inner, grid.size, grid.rank, grid.group)
    batch.source_shards = 1
    return cl._tagged(batch, inner)


def make_cuda_lnprob_stream_sharded(ctx: LFContext, layout, grid):
    """Free completeness on a mega catalog over the grid: walkers split
    over the walker ranks and sources dealt round-robin over the source
    ranks, each rank's card holding only its shard of the streaming
    kernels' source slabs. The rank's streaming route
    (``cuda_lnlike._route`` of its shard: the grid weights over
    ``n_sources``) gives the shard's part, kernel and collapsed source
    terms; one ``all_reduce`` over the source group rebuilds ``lnpart -
    fullint`` (counterpart of ``make_pallas_lnprob_stream_sharded``,
    ``sharding.py:618``), and the route's prior flags mask it. Returns
    None under fixed completeness, as the JAX function does."""
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    if layout.fix_comp:
        return None
    route = cl._route(ctx, layout, "single", grad=False,
                      nshards=grid.n_sources, shard=grid.source_index)
    lnlike = cl._likelihood(route, flags=True)

    def local(thetas):
        part, ok = lnlike(thetas)
        lnl = all_reduce_sum(part, grid.source_group).to(thetas.dtype)
        return torch.where(ok, lnl, torch.full_like(lnl, -math.inf))

    batch = _walker_sharded(local, grid.n_walkers, grid.walker_index,
                            grid.walker_group)
    batch.source_shards = grid.n_sources
    return cl._tagged(batch, route)


def _rows(rands, lo, hi, axis):
    """Rows ``[lo, hi)`` on ``axis`` of every tensor of a ``rands`` tuple
    (a "mix" tuple's host schedule, shared, stays whole)."""
    if isinstance(rands, torch.Tensor):
        return rands.narrow(axis, lo, hi - lo)
    if isinstance(rands, np.ndarray):
        return rands
    return tuple(_rows(r, lo, hi, axis) for r in rands)


def _gather_all(grid, *xs):
    return tuple(None if x is None else all_gather_rows(x, grid.group)
                 for x in xs)


def run_ensembles_sharded_with(lnprob_batch, pos0, rands, nsteps, grid,
                               a=2.0, thin=1, move="stretch"):
    """E independent ensembles over the grid from pre-drawn randoms (those
    of :func:`~lumfuncmcmc_tpu_torch.samplers.affine.run_ensembles_with_rands`
    for all E, each (nsteps, 2, E, W/2)): whole ensembles one or more to a
    rank (E a multiple of the grid's ranks), each rank running its own
    block on its rows of the randoms, with no collective in the loop.
    ``lnprob_batch`` is the per-rank (meshless) batch form, called once a
    half-step over the rank's ensembles' rows. Returns the meshless
    function's tuple, gathered on every rank."""
    from lumfuncmcmc_tpu_torch.samplers.affine import (
        EnsembleState, run_ensembles_with_rands)
    blk = _chain_blk(pos0.shape[0], grid.size, "ensemble")
    e0 = grid.rank * blk
    state, chain, lnps, acc = run_ensembles_with_rands(
        lnprob_batch, pos0[e0:e0 + blk], _rows(rands, e0, e0 + blk, 2),
        nsteps, a, thin, move)
    pos, lnp, chain, lnps, acc = _gather_all(grid, state.pos, state.lnp,
                                             chain, lnps, acc)
    return EnsembleState(pos, lnp), chain, lnps, acc


def run_stretch_ensembles_sharded(lnprob_batch, pos0, generator, nsteps,
                                  grid, a=2.0, thin=1, move="stretch",
                                  de_prob=0.5, de_sel=None):
    """:func:`run_ensembles_sharded_with` on the randoms every rank draws
    for all E ensembles from ``generator``, as
    :func:`~lumfuncmcmc_tpu_torch.samplers.affine.run_stretch_ensembles`
    draws them, so the grid's run is the meshless one (counterpart of
    ``run_stretch_ensembles_sharded``, ``sharding.py:834``)."""
    from lumfuncmcmc_tpu_torch.samplers.affine import check_run, draw_rands
    check_run(pos0, nsteps, thin, move)
    rands = draw_rands(generator, move, nsteps, pos0, de_prob, de_sel)
    return run_ensembles_sharded_with(lnprob_batch, pos0, rands, nsteps,
                                      grid, a, thin, move)


def _ladder_block(grid, K):
    blk = _chain_blk(K, grid.size, "rung")
    return blk, grid.rank * blk


def run_tempered_sharded_with(lnprior_fn, lnlike_fn, pos0, betas, rands,
                              nsteps, grid, a=2.0, move="stretch"):
    """The evidence ladder over the grid from pre-drawn randoms (those of
    :func:`~lumfuncmcmc_tpu_torch.samplers.tempering.run_tempered_with` for
    all K rungs): whole rungs one or more to a rank (K a multiple of the
    grid's ranks), each rank running its own rungs on their rows; rungs
    never meet, so the loop has no collective. ``lnprior_fn`` and
    ``lnlike_fn`` are per-rank. Returns ``(chains, lnls, acc)``, gathered
    on every rank."""
    from lumfuncmcmc_tpu_torch.samplers.tempering import run_tempered_with
    blk, g0 = _ladder_block(grid, pos0.shape[0])
    out = run_tempered_with(lnprior_fn, lnlike_fn, pos0[g0:g0 + blk],
                            np.asarray(betas)[g0:g0 + blk],
                            _rows(rands, g0, g0 + blk, 0), nsteps, a=a,
                            move=move)
    return _gather_all(grid, *out)


def run_tempered_sharded(lnprior_fn, lnlike_fn, pos0, betas, generator,
                         nsteps, grid, a=2.0, move="stretch", de_prob=0.5):
    """:func:`run_tempered_sharded_with` on the randoms every rank draws
    for all K rungs (:func:`~lumfuncmcmc_tpu_torch.samplers.tempering.ladder_rands`),
    so the grid reproduces the meshless
    :func:`~lumfuncmcmc_tpu_torch.samplers.tempering.run_tempered`
    (counterpart of ``run_tempered_sharded``, ``sharding.py:670``)."""
    from lumfuncmcmc_tpu_torch.samplers.tempering import ladder_rands
    K, W, D = pos0.shape
    rands = ladder_rands(generator, K, nsteps, W, D, pos0.dtype,
                         pos0.device, move, de_prob)
    return run_tempered_sharded_with(lnprior_fn, lnlike_fn, pos0, betas,
                                     rands, nsteps, grid, a=a, move=move)


def run_parallel_tempering_sharded_with(lnprior_fn, lnlike_fn, pos0, betas,
                                        rands, u, nsteps, grid,
                                        swap_every: int = 10, a=2.0,
                                        move="stretch", lnls: bool = True):
    """DEO replica exchange with the ladder over the grid, from the
    pre-drawn randoms of
    :func:`~lumfuncmcmc_tpu_torch.samplers.tempering.run_parallel_tempering_with`
    (``rands`` for all K rungs, swap uniforms ``u`` (R, K-1, W)):
    contiguous blocks of K / ranks rungs, rank d holding rungs [d B,
    (d+1) B).

    Each round every rank runs its rungs' steps; at the swap it gathers
    every rank's first and last rung (positions, lnlike, lnprior: the
    only traffic), extends its block with the left neighbour's last and
    the right neighbour's first rung (ghost rungs), and applies the
    meshless :func:`~lumfuncmcmc_tpu_torch.samplers.tempering._pair_swap_block`
    to the extended block, the pairs masked by their global index (no
    pair past either end of the ladder, only the round's parity). So the
    run is the meshless one bit for bit in float64. Returns its
    ``(chains, lnls, acc, swap_frac, swaps)``, gathered on every rank
    (``lnls`` None when ``lnls`` is False)."""
    from lumfuncmcmc_tpu_torch.samplers.tempering import (
        _Tempered, _check_ladder, _exchange, _ladder_steps, _pair_swap_block,
        _start, recompute_lnl)
    if swap_every <= 0:
        raise ValueError("swap_every must be positive (use "
                         "run_tempered_sharded for the swapless ladder)")
    nrounds = nsteps // swap_every
    if nrounds < 1:
        raise ValueError(f"nsteps={nsteps} < swap_every={swap_every}: no "
                         "full round would run")
    _check_ladder(pos0, move)
    K, W, D = pos0.shape
    B, g0 = _ladder_block(grid, K)
    dt, dev = pos0.dtype, pos0.device
    n = nrounds * swap_every
    rands = _rows(rands, g0, g0 + B, 0)
    betas_all = torch.as_tensor(np.asarray(betas), dtype=dt, device=dev)
    tempered = _Tempered(lnprior_fn, lnlike_fn, betas_all[g0:g0 + B])
    # the pair tables padded by one row each side: ext pair i of this
    # block has left rung g0 - 1 + i, i = 0..B (padded row g + 1)
    one = torch.ones((nrounds, 1, W), dtype=dt, device=dev)
    u_rows = torch.cat([one, u, one], dim=1)[:, g0:g0 + B + 1]
    db = betas_all[1:] - betas_all[:-1]
    db_rows = torch.cat([db.new_zeros(1), db, db.new_zeros(1)])[g0:g0 + B + 1]
    g_ext = g0 - 1 + torch.arange(B + 1, device=dev)
    d, ndev = grid.rank, grid.size
    chains = torch.empty((B, n, W, D), dtype=dt, device=dev)
    acc = torch.zeros((B, W), dtype=dt, device=dev)
    swaps = []
    with torch.no_grad():
        state = _start(tempered, pos0[g0:g0 + B])
        for r in range(nrounds):
            lo = r * swap_every
            state, acc_r = _ladder_steps(
                tempered, state, rands, range(lo, lo + swap_every), chains,
                lo, a, move)
            acc += acc_r
            pos, _, lnl, lp = state
            # every rank's (last, first) rung as (pos | lnl | lp) rows
            ends = torch.cat([x[[-1, 0]].reshape(2, W, -1)
                              for x in (pos, lnl, lp)], dim=2)
            ends = all_gather_rows(ends, grid.group).reshape(ndev, 2, W,
                                                             D + 2)
            ext = torch.cat([ends[max(d - 1, 0), 0][None],
                             torch.cat([pos, lnl[..., None], lp[..., None]],
                                       dim=2),
                             ends[min(d + 1, ndev - 1), 1][None]])
            active = ((g_ext >= 0) & (g_ext < K - 1)
                      & (g_ext % 2 == r % 2))
            _, _, do = _pair_swap_block(ext[..., :D], ext[..., D], db_rows,
                                        u_rows[r], active)
            ext = _exchange(ext, do)[1:B + 1]
            pos, lnl, lp = ext[..., :D], ext[..., D], ext[..., D + 1]
            state = (pos, tempered.tempered(lp, lnl), lnl, lp)
            swaps.append(do[1:])       # the pairs whose left rung is here
    lnl_c = recompute_lnl(lnlike_fn, chains) if lnls else None
    swaps = torch.stack(swaps).transpose(0, 1).to(dt)      # (B, R, W)
    chains, lnl_c, acc, swaps = _gather_all(grid, chains, lnl_c, acc, swaps)
    swaps = swaps.transpose(0, 1)[:, :K - 1].bool()        # (R, K-1, W)
    active_n = np.asarray([(nrounds + (1 if k % 2 == 0 else 0)) // 2
                           for k in range(K - 1)], dtype=np.float64)
    swap_frac = (swaps.double().mean(dim=2).sum(dim=0).cpu().numpy()
                 / np.maximum(active_n, 1.0))
    return chains, lnl_c, acc, swap_frac, swaps


def run_parallel_tempering_sharded(lnprior_fn, lnlike_fn, pos0, betas,
                                   generator, nsteps, grid,
                                   swap_every: int = 10, a=2.0,
                                   move="stretch", de_prob=0.5,
                                   lnls: bool = True):
    """:func:`run_parallel_tempering_sharded_with` on the randoms every
    rank draws as the meshless
    :func:`~lumfuncmcmc_tpu_torch.samplers.tempering.run_parallel_tempering`
    does (the steps' draws for all K rungs, then the swaps' uniforms);
    its ``(chains, lnls, acc, swap_frac)`` bit for bit in float64
    (counterpart of ``run_parallel_tempering_sharded``,
    ``sharding.py:706``)."""
    from lumfuncmcmc_tpu_torch.samplers.tempering import ladder_rands
    K, W, D = pos0.shape
    nrounds = nsteps // swap_every if swap_every > 0 else 0
    rands = ladder_rands(generator, K, nrounds * swap_every, W, D,
                         pos0.dtype, pos0.device, move, de_prob)
    u = torch.rand((nrounds, K - 1, W), generator=generator,
                   dtype=pos0.dtype, device=pos0.device)
    return run_parallel_tempering_sharded_with(
        lnprior_fn, lnlike_fn, pos0, betas, rands, u, nsteps, grid,
        swap_every=swap_every, a=a, move=move, lnls=lnls)[:4]


# ---------------------------------------------------------------------------
# NUTS on the grid
# ---------------------------------------------------------------------------

def make_cuda_lnprob_and_grad_stream_sharded(ctx: LFContext, layout, grid,
                                             data=None):
    """(C, D) -> (C,) lnprob of this rank's own rows that autograd
    differentiates, with the catalog split over the source ranks: the
    value+gradient route of the rank's shard (``cuda_lnlike._route``),
    whose kernel call sums the shard's ``free_stream_lnlike_vg`` rows
    (one launch a call), value AND feature gradient, over the source
    group in one ``all_reduce`` (a COLLECTIVE of the source group) and
    whose collapse takes the whole catalog's sums, then the host's
    pullback to theta and the prior mask (JAX's
    ``_stream_vg_local_parts``, ``sharding.py:346``). The backward
    multiplies by the summed gradient columns and reduces nothing
    (``torch.distributed.nn``'s ``all_reduce`` would reduce the cotangent
    again and count the gradient once a rank). ``data``: this rank's shard
    (``prepare_cuda_stream_data(..., shard=k)``), e.g. the value route's,
    else packed here. None under fixed completeness."""
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    if layout.fix_comp:
        return None
    shard = dict(nshards=grid.n_sources, shard=grid.source_index)
    route = cl._route(ctx, layout, "single", True, data=data, **shard)
    data, group = route.data, grid.source_group

    def summed_vg(feats, data):
        return all_reduce_sum(cl.free_stream_lnlike_vg(feats, data), group)

    # the whole catalog's theta-affine source terms: the route's collapse
    # over this shard with the source group's summed sums
    whole = dataclasses.replace(data, sums=all_reduce_sum(data.sums, group))
    local = cl._lnprob(dataclasses.replace(
        route, kernel=lambda f: cl._LnlikeOfFeats.apply(f, data, summed_vg),
        collapse=cl._route(ctx, layout, "single", True, data=whole,
                           **shard).collapse))
    local.source_shards = grid.n_sources
    return local


def make_cuda_vg_stream_sharded(ctx: LFContext, layout, grid, data=None):
    """Batched ``(W, D) -> (lnp (W,), grad (W, D))`` with the catalog split
    over the source ranks and the walkers over the walker ranks (padded to
    a multiple of them), each slice through
    :func:`make_cuda_lnprob_and_grad_stream_sharded` and gathered: the
    gradient surface of a mega catalog on the grid (counterpart of
    ``make_pallas_vg_stream_sharded``, ``sharding.py:381``). A COLLECTIVE
    of the grid. None under fixed completeness."""
    from lumfuncmcmc_tpu_torch.ops import cuda_lnlike as cl
    from lumfuncmcmc_tpu_torch.samplers.nuts import value_and_grad
    post = make_cuda_lnprob_and_grad_stream_sharded(ctx, layout, grid, data)
    if post is None:
        return None
    vg = value_and_grad(post)
    nw, index, group = grid.n_walkers, grid.walker_index, grid.walker_group

    def batch(thetas):
        padded, w = _pad_walkers(thetas, nw)
        blk = padded.shape[0] // nw
        v, g = vg(padded[index * blk:(index + 1) * blk])
        return (all_gather_rows(v, group)[:w],
                all_gather_rows(g, group)[:w])

    batch.source_shards = post.source_shards
    return cl._tagged(batch, post)


class ShardedNutsRun(NamedTuple):
    """A NUTS run on the grid, gathered on every rank of its axis."""

    samples: torch.Tensor     # (S, C, D), unconstrained y
    lnps: torch.Tensor        # (S, C)
    alphas: torch.Tensor      # (S, C)
    eps: torch.Tensor         # (ranks,) each rank's step size
    div_frac: torch.Tensor    # (ranks,) each rank's divergent fraction
    counts: object            # this rank's NutsCounts
    state: tuple              # per chain: y_run (C, D), eps (C,),
                              # scale (C, D)


def nuts_axis(grid, axis):
    """``(ranks, this rank's index, group)`` of the axis NUTS chains split
    over: every rank of the grid ("grid", the per-rank replicas) or the
    walker ranks ("walkers", whose source ranks hold the same chains). No
    grid (None) is one rank: the meshless run."""
    if grid is None:
        return 1, 0, None
    if axis == "grid":
        return grid.size, grid.rank, grid.group
    if axis == "walkers":
        return grid.n_walkers, grid.walker_index, grid.walker_group
    raise ValueError(f"NUTS axis {axis!r} is neither 'grid' nor 'walkers'")


def _chains_gathered(x, group):
    """(S, C_blk, ...) -> (S, C, ...): every rank's chain block in order."""
    return all_gather_rows(x.transpose(0, 1).contiguous(),
                           group).transpose(0, 1)


def _nuts_gathered(run, blk, group):
    """A rank's ``NutsRun`` of ``blk`` chains -> :class:`ShardedNutsRun`."""
    y_run, eps, scale = run.state
    eps = torch.as_tensor(eps, dtype=y_run.dtype, device=y_run.device)
    state = (all_gather_rows(y_run, group),
             all_gather_rows(eps.expand(blk).contiguous(), group),
             all_gather_rows(scale.expand(blk, y_run.shape[1]).contiguous(),
                             group))
    one = eps.reshape(-1)[:1]
    return ShardedNutsRun(
        _chains_gathered(run.samples, group),
        _chains_gathered(run.lnps, group),
        _chains_gathered(run.alphas, group),
        all_gather_rows(one, group),
        all_gather_rows(run.div_frac.reshape(1), group), run.counts, state)


def run_nuts_sharded_with(draw, lnp_y, y0, grid, num_warmup, num_samples,
                          pooled=False, axis="grid", **kw):
    """NUTS chains in blocks over ``axis`` (:func:`nuts_axis`) from the
    whole batch's ``draw(phase, t)`` (``samplers/nuts.py``'s protocol):
    rank i runs :func:`~lumfuncmcmc_tpu_torch.samplers.nuts.run_nuts_with`
    on chains ``[i B, (i+1) B)`` and their rows of the draws, on the
    per-rank ``lnp_y``. ``pooled=False``: each rank adapts its own step
    size and mass from its chains (numpyro's parallel semantics);
    ``pooled=True``: from every rank's chains of the axis, one step size
    and mass for all (the meshless run bit for bit in float64). Returns
    the :class:`ShardedNutsRun` gathered on every rank (counterparts of
    ``run_nuts_sharded`` and ``run_nuts_stream_sharded``,
    ``sharding.py:179,420``)."""
    from lumfuncmcmc_tpu_torch.samplers.nuts import block_draw, run_nuts_with
    n, index, group = nuts_axis(grid, axis)
    blk = _chain_blk(y0.shape[0], n, "chain")
    c0 = index * blk
    run = run_nuts_with(block_draw(draw, c0, c0 + blk), lnp_y,
                        y0[c0:c0 + blk], num_warmup, num_samples,
                        pool=group if pooled else None, **kw)
    return _nuts_gathered(run, blk, group)


def continue_nuts_sharded_with(draw, lnp_y, state, grid, start, stop,
                               axis="grid", max_doublings=8, counts=None):
    """Sampling transitions ``start..stop`` of a warmed-up run from its
    per-chain ``state`` (``ShardedNutsRun.state``, or a checkpoint's,
    written on any grid), each rank continuing its chain block with each
    chain's own frozen step size and mass (counterparts of
    ``continue_nuts_sharded`` / ``continue_nuts_keys_sharded``,
    ``sharding.py:253,301``)."""
    from lumfuncmcmc_tpu_torch.samplers.nuts import (
        block_draw, continue_nuts_with)
    y_run, eps, scale = state
    n, index, group = nuts_axis(grid, axis)
    blk = _chain_blk(y_run.shape[0], n, "chain")
    at = slice(index * blk, (index + 1) * blk)
    eps = torch.as_tensor(eps, dtype=y_run.dtype,
                          device=y_run.device).expand(y_run.shape[0])
    scale = scale.expand(y_run.shape)
    run = continue_nuts_with(block_draw(draw, at.start, at.stop), lnp_y,
                             (y_run[at], eps[at], scale[at]), start, stop,
                             max_doublings, counts)
    return _nuts_gathered(run, blk, group)


def _whole_draw(generator, y, max_doublings):
    from lumfuncmcmc_tpu_torch.samplers.nuts import generator_draw
    return generator_draw(generator, y.shape[0], y.shape[1], max_doublings,
                          y.dtype, y.device)


def run_nuts_sharded(lnp_y, y0, generator, grid, num_warmup, num_samples,
                     pooled=False, axis="grid", max_doublings=8, **kw):
    """:func:`run_nuts_sharded_with` drawing every number from
    ``generator`` (seeded alike on every rank) as the meshless
    :func:`~lumfuncmcmc_tpu_torch.samplers.nuts.run_nuts` does for the
    whole batch."""
    return run_nuts_sharded_with(
        _whole_draw(generator, y0, max_doublings), lnp_y, y0, grid,
        num_warmup, num_samples, pooled=pooled, axis=axis,
        max_doublings=max_doublings, **kw)


def continue_nuts_sharded(lnp_y, state, generator, grid, num_samples,
                          axis="grid", max_doublings=8, counts=None):
    """Extend a warmed-up grid (or meshless) run by ``num_samples``
    transitions, every number from ``generator`` where the run left it:
    on any grid whose ranks divide the chains, the meshless
    :func:`~lumfuncmcmc_tpu_torch.samplers.nuts.continue_nuts` of the same
    per-chain state."""
    return continue_nuts_sharded_with(
        _whole_draw(generator, state[0], max_doublings), lnp_y, state, grid,
        0, num_samples, axis, max_doublings, counts)


def _stream_lnp_y(ctx, layout, grid):
    from lumfuncmcmc_tpu_torch.samplers.nuts import make_unconstrained
    post = make_cuda_lnprob_and_grad_stream_sharded(ctx, layout, grid)
    if post is None:
        return None
    lo, hi = layout.bounds_arrays(ctx.lum.dtype, ctx.lum.device)
    return make_unconstrained(post, lo, hi)[0]


def run_nuts_stream_sharded(ctx: LFContext, layout, grid, y0, generator,
                            num_warmup, num_samples, pooled=True, **kw):
    """Mega-catalog NUTS with chains over the walker ranks and the catalog
    over the source ranks (counterpart of ``run_nuts_stream_sharded``,
    ``sharding.py:420``): :func:`run_nuts_sharded` on the ``walkers`` axis
    with :func:`make_cuda_lnprob_and_grad_stream_sharded` as the per-rank
    lnprob. The ranks of a source group run the same chains on the same
    numbers and get the same summed bits, so they stay in step. ``pooled``
    (default) adapts one step size over the walker ranks. None under fixed
    completeness."""
    lnp_y = _stream_lnp_y(ctx, layout, grid)
    if lnp_y is None:
        return None
    return run_nuts_sharded(lnp_y, y0, generator, grid, num_warmup,
                            num_samples, pooled=pooled, axis="walkers", **kw)


def continue_nuts_stream_sharded(ctx: LFContext, layout, grid, state,
                                 generator, num_samples, **kw):
    """Extend a streaming grid run from its per-chain ``state``, under any
    walker split; the source ranks' count must be the writer's (the
    summation order of the source group is part of the arithmetic).
    Counterpart of ``continue_nuts_stream_sharded`` /
    ``continue_nuts_keys_stream_sharded``, ``sharding.py:510,566``."""
    lnp_y = _stream_lnp_y(ctx, layout, grid)
    if lnp_y is None:
        return None
    return continue_nuts_sharded(lnp_y, state, generator, grid, num_samples,
                                 axis="walkers", **kw)
