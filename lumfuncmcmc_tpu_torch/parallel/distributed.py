"""Multi-process runs (port of ``lumfuncmcmc_tpu/parallel/distributed.py``).

JAX runs one controller per host over every device it sees; PyTorch's
idiom is one process per card. A rank is a process and a card: ranks
come from ``torchrun`` (``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` and the
rendezvous in ``MASTER_ADDR``/``MASTER_PORT``: :func:`init_from_env`) or
from the JAX CLI's ``--distributed host:port,N,pid``
(:func:`init_distributed`). Rank r runs on ``cuda:LOCAL_RANK`` (without
``LOCAL_RANK``, its process id modulo the visible cards). The backend is
NCCL on the cards and gloo on the CPU.

Every rank runs the same program, so every collective below is called by
every rank of its group in the same order. A check whose outcome can
differ by rank (a checkpoint on a disk that is not shared) is decided by
:func:`agree`, which raises on every rank when the ranks disagree, never
on one alone: a rank that raised before a collective would leave the
others waiting in it.

Under gloo a CUDA tensor goes through the host: the collectives copy it
to the CPU and back (``_staged``); NCCL takes it on the card, and a host
tensor (a resume decision's numbers) goes to the rank's card and back.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def parse_distributed_spec(spec: str):
    """Parse the CLI spec ``host:port,num_processes,process_id``."""
    try:
        coord, nproc, pid = spec.rsplit(",", 2)
        return coord, int(nproc), int(pid)
    except ValueError as e:
        raise ValueError(
            f"--distributed expects 'host:port,num_processes,process_id',"
            f" got {spec!r}") from e


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's card: ``LOCAL_RANK``, else its process id (default
    its rank) modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    pid = rank() if process_id is None else int(process_id)
    return pid % max(torch.cuda.device_count(), 1)


def _default_backend():
    return "nccl" if torch.cuda.is_available() else "gloo"


def _init(backend, timeout, **kw):
    backend = backend or _default_backend()
    if backend == "nccl":
        torch.cuda.set_device(local_rank(kw.get("rank")))
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, **kw)


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: Optional[str] = None,
                     timeout: Optional[float] = None) -> None:
    """Join the process group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator`` ("host:port") as rank ``process_id``.
    ``backend``: NCCL where a card is visible and gloo elsewhere, unless
    named (gloo lets several ranks share one card, which NCCL refuses).
    ``timeout`` (seconds) bounds every collective's wait."""
    _init(backend, timeout, init_method=f"tcp://{coordinator}",
          world_size=int(num_processes), rank=int(process_id))


def init_from_env(backend: Optional[str] = None,
                  timeout: Optional[float] = None) -> None:
    """Join the process group ``torchrun`` describes in the environment."""
    _init(backend, timeout, init_method="env://",
          rank=int(os.environ["RANK"]),
          world_size=int(os.environ["WORLD_SIZE"]))


def launched_by_torchrun() -> bool:
    return int(os.environ.get("WORLD_SIZE", "1")) > 1 and "RANK" in os.environ


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes artifacts (rank 0)."""
    return rank() == 0


def rank_device(device="cuda") -> torch.device:
    """The card of this rank for ``device`` "cuda" (``cuda:LOCAL_RANK``
    in a process group, else ``cuda:0``); "cpu" stays the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank() if dist.is_initialized()
                            else 0)
    return device


def _staged(x, group):
    """``x`` where the group's backend takes it: a CUDA tensor through the
    host under gloo, a host tensor on this rank's card under NCCL."""
    backend = dist.get_backend(group)
    if x.device.type == "cuda" and backend == "gloo":
        return x.cpu()
    if x.device.type == "cpu" and backend == "nccl":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x


def group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ranks' ``x`` (equal shapes), concatenated on the first
    axis in group-rank order. A group of one returns ``x``."""
    if group_size(group) == 1:
        return x
    y = _staged(x.contiguous(), group)
    parts = [torch.empty_like(y) for _ in range(group_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of the group's ranks' ``x``, the same bits on every rank."""
    if group_size(group) == 1:
        return x
    y = _staged(x.clone(), group)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


def to_host(x: torch.Tensor, group=None) -> np.ndarray:
    """A walker- or ensemble-sharded tensor, every rank's block gathered
    on the first axis, as host numpy. A COLLECTIVE: every rank of
    ``group`` calls it on its block in the same order."""
    return all_gather_rows(x, group).cpu().numpy()


def agree(values, what: str, group=None) -> None:
    """Raise on every rank of ``group`` unless every rank holds the same
    ``values`` (numbers). A COLLECTIVE: every rank calls it."""
    if group_size(group) == 1:
        return
    mine = torch.as_tensor(np.asarray(values, dtype=np.float64).ravel())
    seen = all_gather_rows(mine[None], group).numpy()
    same = (seen == seen[0]) | (np.isnan(seen) & np.isnan(seen[0]))
    if not same.all():
        raise RuntimeError(
            f"the ranks disagree on {what}: {seen.tolist()} by group rank "
            "(a file on a disk that is not shared? put it on shared "
            "storage, or copy it to every host, and rerun)")


def barrier(group=None) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def smoke_check() -> dict:
    """Cross-rank sanity: gather the ranks' ids and sum a walker-sharded
    vector of ones over a ``(world, 1)`` grid. Returns the facts that
    ``lumfuncmcmc_tpu.parallel.distributed.smoke_check`` returns, one
    card a rank."""
    from lumfuncmcmc_tpu_torch.parallel.mesh import make_mesh

    pids = to_host(torch.tensor([rank()]),
                   dist.group.WORLD if dist.is_initialized() else None)
    grid = make_mesh(world_size(), 1)
    total = all_reduce_sum(torch.ones(1, dtype=torch.float64),
                           grid.walker_group)
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "device_count": world_size(),
        "local_device_count": 1,
        "gathered_pids": sorted(int(p) for p in pids.tolist()),
        "psum_total": float(total.item()),
    }
