"""Where this process runs: rank, world, local rank and the rendezvous
address, from the launcher's environment.

Port of ``stochastic_gradient_push_tpu/parallel/discovery.py``
(``discover:38``, ``initialize_multihost:51``), written for
``torch.distributed``: one process per rank, as the original PyTorch
reference runs (``gossip_sgd.py:586-605``).  :func:`discover` reads
``torchrun``'s variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or SLURM's
(``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``, the first host of
``SLURM_JOB_NODELIST``, ``MASTER_PORT`` or the reference's 40100), and
says a single process otherwise.  Joining the group is
``parallel/multihost.py::initialize_multihost``.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess

__all__ = ["ClusterInfo", "discover"]

DEFAULT_PORT = "40100"   # the reference's --master_port


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """What the launch layer needs to know about where it runs."""

    launcher: str            # "torchrun", "slurm" or "single"
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    master_addr: str
    master_port: str

    @property
    def is_multiprocess(self) -> bool:
        return self.world_size > 1

    @property
    def init_method(self) -> str:
        return f"tcp://{self.master_addr}:{self.master_port}"


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist (``node-[003-007,010]`` →
    ``node-003``; ``a-1,b-2`` → ``a-1``), from ``scontrol show
    hostnames`` where it runs."""
    try:
        out = subprocess.run(["scontrol", "show", "hostnames", nodelist],
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.split()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    bracket = nodelist.find("[")
    if bracket == -1:
        return nodelist.split(",")[0]
    inside = nodelist[bracket + 1:nodelist.index("]", bracket)]
    return nodelist[:bracket] + inside.split(",")[0].split("-")[0]


def discover(env=None) -> ClusterInfo:
    """This process's place in the run, from ``env`` (default
    ``os.environ``): torchrun's variables first, then SLURM's, else a
    single process."""
    env = os.environ if env is None else env
    if "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", 0))
        return ClusterInfo(
            "torchrun", rank, world, int(env.get("LOCAL_RANK", rank)),
            int(env.get("LOCAL_WORLD_SIZE", world)),
            env.get("MASTER_ADDR", "127.0.0.1"),
            env.get("MASTER_PORT", DEFAULT_PORT))
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        world = int(env["SLURM_NTASKS"])
        nodelist = env.get("SLURM_JOB_NODELIST", "")
        return ClusterInfo(
            "slurm", int(env["SLURM_PROCID"]), world,
            int(env.get("SLURM_LOCALID", 0)),
            # "4(x2)" on a homogeneous allocation
            int(str(env.get("SLURM_NTASKS_PER_NODE", world)).split("(")[0]),
            env.get("MASTER_ADDR") or (_first_slurm_host(nodelist)
                                       if nodelist else "127.0.0.1"),
            env.get("MASTER_PORT", DEFAULT_PORT))
    return ClusterInfo("single", 0, 1, 0, 1, "127.0.0.1", DEFAULT_PORT)
