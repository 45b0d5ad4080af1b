"""Launching a port test's gloo processes on a rendezvous that the test
holds.

A test that picks a free port, closes it and hands it to its children
races every other process on the machine: its rank 0 binds the port
seconds later, after importing torch, and under ``pytest -n`` the other
workers' gloo processes open ephemeral listeners and connections
meanwhile.  Here the test's own process holds the ``TCPStore`` server,
bound to a port the kernel picked and never released while the children
run, and the children join it as clients: ``TORCHELASTIC_USE_AGENT_STORE``
makes ``torch.distributed``'s ``tcp://`` and ``env://`` rendezvous
connect to the launcher's store instead of starting one on rank 0, as
``torchrun``'s agent does.  Each launch gets a store of its own.

:class:`Rendezvous` is one store (``port``, ``env()``, ``popen()``: a
child it serves keeps it alive), :func:`join` waits for children with a
time limit each and kills the rest, :func:`spawn` runs ``world``
children that take the port in their arguments, and :func:`torchrun`
runs ``world`` children under a torchrun environment.
"""

from __future__ import annotations

import os
import subprocess
import typing

__all__ = ["TIMEOUT", "Rendezvous", "join", "spawn", "torchrun"]

TIMEOUT = 240
HOST = "127.0.0.1"


class Rendezvous:
    """A ``TCPStore`` server held in this process on a port the kernel
    picked."""

    def __init__(self):
        from torch.distributed import TCPStore

        self._store = TCPStore(HOST, 0, is_master=True,
                               wait_for_workers=False)
        self.port = self._store.port

    def env(self, rank: int | None = None, world: int | None = None,
            drop=(), **extra) -> dict:
        """``os.environ`` with one torch thread, the rendezvous and (with
        ``rank`` and ``world``) the torchrun variables of that rank, then
        ``extra``, less the variables named in ``drop``."""
        env = dict(os.environ, MASTER_ADDR=HOST, MASTER_PORT=str(self.port),
                   TORCHELASTIC_USE_AGENT_STORE="True",
                   TORCHELASTIC_RESTART_COUNT="0", OMP_NUM_THREADS="1")
        if rank is not None:
            env.update(RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        env.update(extra)
        for k in drop:
            env.pop(k, None)
        return env

    def popen(self, argv: list, rank: int | None = None,
              world: int | None = None, env: dict | None = None,
              drop=(), **kw) -> subprocess.Popen:
        """A child on this rendezvous (``env``: more environment,
        ``drop``: variables taken out), stdout and stderr piped together;
        it holds the store alive."""
        proc = subprocess.Popen(argv, env=self.env(rank, world, drop,
                                                   **(env or {})),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, **kw)
        proc.rendezvous = self
        return proc


def join(procs, timeout: float = TIMEOUT, check: bool = True) -> list[str]:
    """Each child's output (stdout with stderr), waiting ``timeout``
    seconds on each; kills whatever is left; with ``check``, asserts
    every child exited 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if check:
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return logs


def spawn(world: int, argv_of: typing.Callable[[int, int], list],
          timeout: float = TIMEOUT, **env) -> list[str]:
    """Run ``argv_of(rank, port)`` for every rank of ``world`` on a fresh
    rendezvous (``env``: more environment); each rank's output."""
    rdv = Rendezvous()
    return join([rdv.popen(argv_of(r, rdv.port), env=env)
                 for r in range(world)], timeout)


def torchrun(world: int, argv_of: typing.Callable[[int], list],
             timeout: float = TIMEOUT, **env) -> list[str]:
    """Run ``argv_of(rank)`` for every rank of ``world`` under a torchrun
    environment on a fresh rendezvous (``env``: more environment); each
    rank's output."""
    rdv = Rendezvous()
    return join([rdv.popen(argv_of(r), r, world, env=env)
                 for r in range(world)], timeout)
