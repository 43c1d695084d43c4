"""The ``(walkers, sources)`` grid of ranks (port of
``lumfuncmcmc_tpu/parallel/mesh.py``).

The JAX package lays a 2-D logical mesh over the devices of one
controller: the ``walkers`` axis evaluates the ensemble's walkers in
parallel (its only collective gathers the half ensemble's lnprob, tiny),
the ``sources`` axis sums the per-source ln-terms of the likelihood with a
``psum``. Here the mesh's devices are ranks, one process and one card a
rank: rank ``d`` sits at ``(d // n_sources, d % n_sources)``, as device
``d`` of the JAX mesh does, so a multi-host run puts the walker axis
across hosts and each rank's source group within its host.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

from lumfuncmcmc_tpu_torch.parallel.distributed import rank, world_size

AXIS_WALKERS = "walkers"
AXIS_SOURCES = "sources"


@dataclass(frozen=True)
class Grid:
    """A ``n_walkers x n_sources`` grid of ranks and this rank's place in
    it. ``walker_group`` holds the ranks of this rank's source coordinate
    (they split the walkers), ``source_group`` those of its walker
    coordinate (they split the sources), ``group`` every rank of the grid;
    None where the group is this rank alone. An idle rank (the grid uses
    fewer ranks than the world has) has no coordinates."""

    n_walkers: int
    n_sources: int
    rank: int
    world: int
    walker_index: Optional[int]
    source_index: Optional[int]
    walker_group: Any = None
    source_group: Any = None
    group: Any = None

    @property
    def size(self) -> int:
        return self.n_walkers * self.n_sources

    @property
    def shape(self) -> dict:
        return {AXIS_WALKERS: self.n_walkers, AXIS_SOURCES: self.n_sources}

    @property
    def idle(self) -> bool:
        return self.walker_index is None


def make_mesh(n_walkers: int = 0, n_sources: int = 1) -> Grid:
    """Build the ``(walkers, sources)`` grid over the process group's
    ranks (one rank without a process group).

    ``n_walkers=0`` means "every rank left": with 8 ranks and
    ``n_sources=2`` the grid is 4x2. A COLLECTIVE: every rank of the world
    calls it with the same sizes (the sub-groups are made by
    ``dist.new_group``, which every rank joins in the same order).
    """
    world, me = world_size(), rank()
    if n_walkers <= 0:
        n_walkers = max(1, world // max(1, n_sources))
    use = n_walkers * n_sources
    if use > world:
        raise ValueError(
            f"mesh {n_walkers}x{n_sources} needs {use} devices, have "
            f"{world} (one card a rank: launch {use} ranks with torchrun "
            f"--nproc-per-node {use}, or --distributed)")
    if use < world:
        warnings.warn(f"mesh {n_walkers}x{n_sources} uses {use} of {world} "
                      f"devices; {world - use} sit idle (pick axis sizes "
                      "whose product divides the device count)",
                      stacklevel=2)
    groups = {}
    if world > 1:
        def new(ranks):
            g = dist.new_group(ranks)
            return g if me in ranks and len(ranks) > 1 else None
        for s in range(n_sources):
            ranks = [w * n_sources + s for w in range(n_walkers)]
            g = new(ranks)
            if me in ranks:
                groups["walker_group"] = g
        for w in range(n_walkers):
            ranks = [w * n_sources + s for s in range(n_sources)]
            g = new(ranks)
            if me in ranks:
                groups["source_group"] = g
        groups["group"] = new(list(range(use)))
    inside = me < use
    return Grid(n_walkers=n_walkers, n_sources=n_sources, rank=me,
                world=world,
                walker_index=me // n_sources if inside else None,
                source_index=me % n_sources if inside else None, **groups)
