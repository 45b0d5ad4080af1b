"""One rank per process: joining the group, the process's device, and the
host-side views of a run spread over processes.

Port of ``stochastic_gradient_push_tpu/parallel/multihost.py``
(``consensus_resume_point:39``, ``to_host:135``, ``host_local_slice:142``)
for ``torch.distributed``, where every process holds one gossip rank and
its tensors carry a leading rank dim of 1 (``collectives.DistTransport``):

* :func:`initialize_multihost` joins the default group with the backend
  ``--backend`` names (the original reference's ``nccl|gloo``; ``xla``,
  the JAX package's default, means nccl on CUDA and gloo on the CPU).
  NCCL refuses two ranks on one card, so where ranks share a card
  ``xla`` means gloo; on the kernel lane the gossip payload never goes
  through the group (``ops/gossip_kernel.py``'s cross-process K2).
* :func:`process_device` is ``cuda:{LOCAL_RANK % device_count}``, so
  ranks may share a card.
* :func:`consensus_resume_point` agrees on the least ``(epoch, itr)``
  over its transport's group: the world's, so every process resumes at
  one step.
* :func:`to_host` gathers each rank's metric row over its transport's
  group (the gossip ranks); :func:`host_local_slice` is this process's
  rows, and under ``--sp`` its ``(replica, shard)`` block.
* :func:`leave` frees the transport and leaves a group the run started,
  on a run's end and on its exit 75 alike (a process that exits with
  the group still up can abort in its teardown).

Under ``--sp`` > 1 a process holds one sequence shard of one gossip
replica (``parallel/mesh.py``): the helpers take the transport of the
group they agree over (the world's for the resume point, the replicas'
dp group for the metrics), as the caller passes it.
"""

from __future__ import annotations

import datetime
import itertools

import numpy as np
import torch

from ..device import resolve_device
from .discovery import ClusterInfo, discover

__all__ = ["BACKENDS", "resolve_backend", "process_device",
           "initialize_multihost", "consensus_resume_point", "to_host",
           "host_local_slice", "leave"]

BACKENDS = ("xla", "nccl", "gloo", "mpi")
# this process's joins of a default group, in order (initialize_multihost)
_JOINS = itertools.count()


def resolve_backend(flag: str, device: torch.device,
                    info: ClusterInfo | None = None) -> str:
    """The ``torch.distributed`` backend for ``--backend``: ``xla`` (the
    default) is nccl on a CUDA device, gloo on the CPU and gloo where the
    node's ranks outnumber its cards (NCCL refuses two ranks on one
    card)."""
    if flag not in BACKENDS:
        raise ValueError(f"unknown backend {flag!r}; one of {BACKENDS}")
    if flag == "xla":
        if device.type != "cuda":
            return "gloo"
        info = info or discover()
        shared = info.local_world_size > torch.cuda.device_count()
        return "gloo" if shared else "nccl"
    if flag == "nccl" and device.type != "cuda":
        raise ValueError("--backend nccl needs a CUDA device; the CPU "
                         "takes gloo")
    return flag


def process_device(device=None, info: ClusterInfo | None = None
                   ) -> torch.device:
    """This process's device: ``cuda:{local_rank % device_count}`` for
    ``None`` or a bare ``cuda`` (ranks beyond the cards share them), the
    named device otherwise; a CUDA device without a card raises
    ``DeviceUnavailableError``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        info = info or discover()
        dev = torch.device("cuda",
                           info.local_rank % torch.cuda.device_count())
    return dev


def initialize_multihost(backend: str = "xla", device=None,
                         info: ClusterInfo | None = None,
                         timeout_s: float | None = None) -> ClusterInfo:
    """Join the default group as ``info`` (default: :func:`discover`)
    says, with ``--backend``'s backend on ``device`` (CUDA devices are
    made current first).  A group that is already up is kept.

    Each join of this process gets keys of its own on the rendezvous
    store (a ``PrefixStore`` named by the join's number, the same in every
    process that joins as often).  torch names a default group's keys
    alike every time, and a store that outlives a group (torchrun's agent
    store, or a launcher's held one) still holds the first group's
    addresses: a process that read its peer's before the peer rewrote it
    dialled a closed port and the second group hung."""
    import torch.distributed as dist

    info = info or discover()
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {} if timeout_s is None else {
            "timeout": datetime.timedelta(seconds=timeout_s)}
        store, rank, world = next(dist.rendezvous(
            info.init_method, info.rank, info.world_size, **kw))
        store = dist.PrefixStore(f"sgp_join/{next(_JOINS)}", store)
        dist.init_process_group(resolve_backend(backend, dev, info),
                                store=store, world_size=world, rank=rank,
                                **kw)
    return info


def consensus_resume_point(epoch: int, itr: int, transport,
                           log=None) -> tuple[int, int]:
    """The least ``(epoch, itr)`` any process restored: every process
    must run the same number of steps, or the collectives deadlock, so a
    torn save window resumes everyone from the earliest point (the ahead
    processes' state simply trains on).  A disagreement is logged."""
    if transport.world_size == len(transport.ranks):
        return epoch, itr
    mine = torch.tensor([[epoch, itr]], dtype=torch.int64)
    pts = sorted({(int(e), int(i)) for e, i in transport.gather(mine)})
    if log is not None and len(pts) > 1:
        log.warning(
            f"restored checkpoints disagree across processes: {pts}; "
            f"resuming all from {pts[0]} (replicas restored from later "
            "steps carry newer parameters until gossip reconciles them)")
    return pts[0]


def to_host(x: torch.Tensor, transport) -> np.ndarray:
    """Every rank's row of a rank-stacked ``x`` as numpy ``[world, ...]``:
    the held rows as they are, or gathered from every process."""
    if transport.world_size == len(transport.ranks):
        return x.detach().cpu().numpy()
    return transport.gather(x.detach()).numpy()


def host_local_slice(tree: dict, transport, shards=None) -> dict:
    """This process's rows of a world-stacked dict of arrays or tensors:
    the gossip ranks ``transport`` holds, and with ``shards`` (the
    sequence shards held here, ``seq.shards``) those of dim 1, so a
    ``[dp, sp, ...]`` batch gives this process's ``(replica, shard)``
    block ``[1, 1, ...]``."""
    rows = np.asarray(transport.ranks)
    cols = None if shards is None else np.asarray(shards)

    def take(v):
        if not isinstance(v, np.ndarray):
            v = v[torch.as_tensor(rows, device=v.device)]
            return v if cols is None else v[:, torch.as_tensor(
                cols, device=v.device)]
        return v[rows] if cols is None else v[rows][:, cols]

    return {k: take(v) for k, v in tree.items()}


def leave(transport, owns_group: bool) -> None:
    """Free ``transport``'s landing blocks (a collective on the kernel
    lane) and, when this run joined the group (``owns_group``), destroy
    it.  Every process calls it at the same point."""
    transport.close()
    if owns_group:
        import torch.distributed as dist

        dist.destroy_process_group()
