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
* :func:`consensus_resume_point` agrees on the least ``(epoch, itr)``.
* :func:`to_host` gathers each rank's metric row, so rank 0 sees every
  rank's; :func:`host_local_slice` is this process's rows.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from ..device import resolve_device
from .discovery import ClusterInfo, discover

__all__ = ["BACKENDS", "resolve_backend", "process_device",
           "initialize_multihost", "consensus_resume_point", "to_host",
           "host_local_slice"]

BACKENDS = ("xla", "nccl", "gloo", "mpi")


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
    made current first).  A group that is already up is kept."""
    import torch.distributed as dist

    info = info or discover()
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {} if timeout_s is None else {
            "timeout": datetime.timedelta(seconds=timeout_s)}
        dist.init_process_group(resolve_backend(backend, dev, info),
                                init_method=info.init_method,
                                world_size=info.world_size, rank=info.rank,
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


def host_local_slice(tree: dict, transport) -> dict:
    """This process's rows of a world-stacked dict of arrays or
    tensors."""
    rows = np.asarray(transport.ranks)
    return {k: v[rows] if isinstance(v, np.ndarray) else v[
        torch.as_tensor(rows, device=v.device)] for k, v in tree.items()}
