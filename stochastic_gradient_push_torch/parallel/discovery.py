"""Where this process runs: rank, world, local rank and the rendezvous
address, from the command line's flags or the launcher's environment.

Port of ``stochastic_gradient_push_tpu/parallel/discovery.py``
(``initialize_multihost:51``, ``_first_slurm_host:123``) and the
reference CLIs' ``_multihost_env`` (``run/gossip_sgd.py:871`` there),
written for ``torch.distributed``: one process per rank, as the original
PyTorch reference runs (``gossip_sgd.py:586-605``).  :func:`discover`
reads, in the reference's order:

* **the flags** ``--coordinator_address host:port``, ``--num_processes``
  and ``--process_id`` (:class:`ClusterInfo` ``"flags"``, rendezvous at
  ``tcp://host:port``; ``JAX_COORDINATOR_ADDRESS`` stands in for the
  first);
* **SLURM's** variables (``SLURM_PROCID``, ``SLURM_NTASKS``,
  ``SLURM_LOCALID``, the first host of ``SLURM_JOB_NODELIST``, else
  ``HOSTNAME``; the port ``COORDINATOR_PORT``, ``MASTER_PORT`` or the
  reference's 40100);
* **OpenMPI's** (``OMPI_COMM_WORLD_RANK``, ``OMPI_COMM_WORLD_SIZE`` or
  ``OMPI_UNIVERSE_SIZE``, ``OMPI_COMM_WORLD_LOCAL_RANK`` and
  ``_LOCAL_SIZE``; the coordinator ``COORDINATOR_ADDRESS``, host or
  host:port, else a propagated ``HOSTNAME``; a multi-node launch with
  neither is refused, as the reference refuses it);

and, as before the flags were ported, **torchrun's** (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), which keep their meaning under every ``--multihost``.
``--multihost auto`` joins where :func:`multihost_env` finds a launcher
of more than one process, ``True`` always, ``False`` never (one process
under SLURM's, OpenMPI's or the coordinator's variables).  The local
rank comes from ``LOCAL_RANK``, ``SLURM_LOCALID`` or
``OMPI_COMM_WORLD_LOCAL_RANK``, else it is the process id, and picks the
process's card (``parallel/multihost.py::process_device``).  A flag set
that does not fit is a ``ValueError`` naming the flag.  Joining the
group is ``parallel/multihost.py::initialize_multihost``.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess

__all__ = ["ClusterInfo", "discover", "multihost_env", "MULTIHOST_CHOICES"]

DEFAULT_PORT = "40100"   # the reference's --master_port and COORDINATOR_PORT
MULTIHOST_CHOICES = ("auto", "True", "False")


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """What the launch layer needs to know about where it runs."""

    launcher: str            # "flags", "torchrun", "slurm", "mpi", "single"
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
    def coordinator(self) -> str:
        """``host:port``, what the reference hands
        ``jax.distributed.initialize`` as ``coordinator_address``."""
        return f"{self.master_addr}:{self.master_port}"

    @property
    def init_method(self) -> str:
        return f"tcp://{self.coordinator}"


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


def _int(env, *names, default=None):
    for n in names:
        if env.get(n):
            return int(env[n])
    return default


def _split_host(address: str, port: str) -> tuple[str, str]:
    """``host:port`` or a bare ``host`` (then ``port``)."""
    host, sep, p = address.rpartition(":")
    return (host, p) if sep and host else (address, port)


def multihost_env(env=None) -> bool:
    """Whether ``--multihost auto`` joins a group: SLURM with more than
    one task, OpenMPI with more than one process or an explicit
    ``JAX_COORDINATOR_ADDRESS`` (the reference's ``_multihost_env``), or
    torchrun's ``WORLD_SIZE`` above 1 (the port's launch before the
    flags)."""
    env = os.environ if env is None else env
    if env.get("JAX_COORDINATOR_ADDRESS"):
        return True
    try:
        return (_int(env, "SLURM_NTASKS", default=1) > 1
                or _int(env, "OMPI_COMM_WORLD_SIZE", "OMPI_UNIVERSE_SIZE",
                        default=1) > 1
                or _int(env, "WORLD_SIZE", default=1) > 1)
    except ValueError:
        return False


def _local(env, rank: int, world: int) -> tuple[int, int]:
    """The local rank and the processes on this host: the launcher's,
    else the process id and the whole world (one host)."""
    local = _int(env, "LOCAL_RANK", "SLURM_LOCALID",
                 "OMPI_COMM_WORLD_LOCAL_RANK", default=rank)
    size = _int(env, "LOCAL_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE")
    if size is None and env.get("SLURM_NTASKS_PER_NODE"):
        # "4(x2)" on a homogeneous allocation
        size = int(str(env["SLURM_NTASKS_PER_NODE"]).split("(")[0])
    return local, world if size is None else size


def _torchrun(env) -> ClusterInfo:
    world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", 0))
    return ClusterInfo(
        "torchrun", rank, world, int(env.get("LOCAL_RANK", rank)),
        int(env.get("LOCAL_WORLD_SIZE", world)),
        env.get("MASTER_ADDR", "127.0.0.1"),
        env.get("MASTER_PORT", DEFAULT_PORT))


def _slurm(env) -> ClusterInfo:
    rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
    nodelist = env.get("SLURM_JOB_NODELIST", "")
    head = env.get("MASTER_ADDR") or (
        _first_slurm_host(nodelist) if nodelist
        else env.get("HOSTNAME", "localhost"))
    port = env.get("COORDINATOR_PORT") or env.get("MASTER_PORT",
                                                  DEFAULT_PORT)
    return ClusterInfo("slurm", rank, world, *_local(env, rank, world),
                       head, port)


def _mpi(env) -> ClusterInfo:
    rank = int(env["OMPI_COMM_WORLD_RANK"])
    world = _int(env, "OMPI_COMM_WORLD_SIZE", "OMPI_UNIVERSE_SIZE")
    if world is None:
        raise ValueError("OMPI_COMM_WORLD_RANK is set but neither "
                         "OMPI_COMM_WORLD_SIZE nor OMPI_UNIVERSE_SIZE")
    head = env.get("COORDINATOR_ADDRESS")
    if head is None:
        # a HOSTNAME fallback is sound only where every rank resolves rank
        # 0's host: one node, or `mpirun -x HOSTNAME` (then it differs from
        # this machine's own name on a remote node); a remote rank whose
        # HOSTNAME is its own would dial itself (the reference's check)
        local = _int(env, "OMPI_COMM_WORLD_LOCAL_SIZE", default=world)
        env_host = env.get("HOSTNAME")
        own = socket.gethostname().split(".")[0]
        propagated = (env_host is not None
                      and env_host.split(".")[0] != own)
        if world > local and rank > 0 and not propagated:
            raise ValueError(
                "multi-node MPI launch needs COORDINATOR_ADDRESS "
                "(host[:port] of rank 0) or mpirun -x HOSTNAME; refusing "
                "to guess a coordinator from this rank's own hostname")
        head = env_host or "localhost"
    host, port = _split_host(head, env.get("COORDINATOR_PORT",
                                           DEFAULT_PORT))
    return ClusterInfo("mpi", rank, world, *_local(env, rank, world), host,
                       port)


def _flag(flags, name: str):
    return None if flags is None else getattr(flags, name, None)


def _check_flags(info: ClusterInfo, nproc, pid) -> ClusterInfo:
    """``info`` if the explicit flags agree with it, else ``ValueError``
    naming the first that does not."""
    if nproc is not None and nproc != info.world_size:
        raise ValueError(f"--num_processes {nproc} but the {info.launcher} "
                         f"launcher started {info.world_size} processes")
    if pid is not None and pid != info.rank:
        raise ValueError(f"--process_id {pid} but the {info.launcher} "
                         f"launcher made this process {info.rank}")
    return info


def discover(env=None, flags=None) -> ClusterInfo:
    """This process's place in the run, from ``flags`` (an object with
    the CLIs' ``multihost``, ``coordinator_address``, ``num_processes``
    and ``process_id``, or None) and ``env`` (default ``os.environ``):
    torchrun's variables as they stand; else, where ``--multihost``
    joins, the flags, SLURM's or OpenMPI's; else a single process."""
    env = os.environ if env is None else env
    mode = _flag(flags, "multihost") or "auto"
    if mode not in MULTIHOST_CHOICES:
        raise ValueError(f"--multihost {mode}: one of {MULTIHOST_CHOICES}")
    coord = _flag(flags, "coordinator_address")
    nproc = _flag(flags, "num_processes")
    pid = _flag(flags, "process_id")
    if nproc is not None and nproc < 1:
        raise ValueError(f"--num_processes {nproc}: must be >= 1")
    if pid is not None and not 0 <= pid < (nproc or pid + 1):
        raise ValueError(f"--process_id {pid}: not in [0, --num_processes "
                         f"{nproc})")
    if "WORLD_SIZE" in env:
        return _check_flags(_torchrun(env), nproc, pid)
    explicit = [f for f, v in (("--coordinator_address", coord),
                               ("--num_processes", nproc),
                               ("--process_id", pid)) if v is not None]
    if mode == "False" or (mode == "auto" and not multihost_env(env)):
        if explicit:
            raise ValueError(
                f"{explicit[0]} with --multihost {mode}: no launcher "
                f"started this process (SLURM, OpenMPI, torchrun or "
                f"JAX_COORDINATOR_ADDRESS), so the run is one process; "
                f"pass --multihost True to join with the flags")
        return ClusterInfo("single", 0, 1, 0, 1, "127.0.0.1", DEFAULT_PORT)
    coord = coord or env.get("JAX_COORDINATOR_ADDRESS")
    if coord and pid is not None:
        if nproc is None:
            raise ValueError(f"--process_id {pid} needs --num_processes")
        host, port = _split_host(coord, DEFAULT_PORT)
        if not host:
            raise ValueError(f"--coordinator_address {coord!r}: no host")
        return ClusterInfo("flags", pid, nproc, *_local(env, pid, nproc),
                           host, port)
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        return _check_flags(_slurm(env), nproc, pid)
    if "OMPI_COMM_WORLD_RANK" in env:
        return _check_flags(_mpi(env), nproc, pid)
    if coord:
        raise ValueError(f"--coordinator_address {coord} needs "
                         f"--num_processes and --process_id (no SLURM or "
                         f"OpenMPI variables give them)")
    raise ValueError("--multihost True: no --coordinator_address, and no "
                     "SLURM, OpenMPI or torchrun variables to join by")
