"""Layouts of a world: nodes of ``nprocs_per_node`` devices, and the
``(gossip, pipe, ep, seq, tp)`` grid of replicas, pipeline stages,
expert shards, sequence shards and tensor shards.

Counterpart of ``stochastic_gradient_push_tpu/parallel/mesh.py``'s
``make_hierarchical_mesh`` and of ``make_dp_sp_mesh``,
``make_dp_tp_mesh`` and ``make_dp_sp_tp_mesh``
(``stochastic_gradient_push_tpu/train/lm.py:61-76``).  The port has no
device mesh: a rank-stacked tensor's leading dim is its rank axis, and
the batch's rows are devices in the reference's mesh-flat order, device
row ``d = node * L + l``.  The gossip runs between the nodes and the
train step averages gradients, BatchNorm statistics and metrics exactly
over a node's ``L`` rows (``train/step.py``'s ``local_axis``), the
original's ``nprocs_per_node`` (its ``distributed.py:62-78``).

Under ``torchrun``, :class:`DpSpLayout` places the ``P`` processes on
the reference's ``(gossip, ep, seq, tp)`` grid in its device order
(``make_dp_ep_sp_tp_mesh``, ``stochastic_gradient_push_tpu/train/
lm.py:107-115``): process ``p = ((replica·ep + e)·sp + shard)·tp + t``
is tp shard ``t`` of sequence shard ``shard`` of expert shard ``e`` of
gossip replica ``replica``.  A pipeline run (``pp`` > 1, tp 1: the
reference refuses pp × tp) takes the reference's ``(gossip, pipe, ep,
seq)`` order (``make_dp_pp_ep_sp_mesh``, ``stochastic_gradient_push_tpu/
train/pp.py:56-94``): process ``p = ((replica·pp + s)·ep + e)·sp +
shard`` is stage ``s``; the ``pp`` processes of one ``(replica, e,
shard)`` form its **pipe group** (the stage hand-offs and the sums of
the replicated leaves' gradients over stages, ``parallel/
pipeline.py``), and every other group is made per stage.  At ``ep == 1`` that is the ``(gossip, seq,
tp)`` order of ``make_dp_sp_tp_mesh``, at ``ep == tp == 1`` the
``(gossip, seq)`` order of ``make_dp_sp_mesh``, at ``sp == tp == 1`` the
``(gossip, ep)`` order of ``make_dp_ep_mesh``.  The ``tp`` processes of
one ``(replica, e, shard)`` form its **tp group** (the Megatron
reductions, ``parallel/tp.py``); the ``sp`` ones of one ``(replica, e,
t)`` its **sp group** (ring shifts, the mean of loss and gradients over
shards); the ``ep`` ones of one ``(replica, shard, t)`` its **ep group**
(the token exchange and the means over expert shards, ``parallel/
ep.py``); the ``dp`` processes of one ``(e, shard, t)`` index form its
**dp group** (the gossip round and every mean over replicas), one an
``(s, e, shard, t)`` under pp; agreement (signals, the resume point)
stays on the world.  :func:`join_groups` makes every group of the five
kinds, in one order in every process (``new_group`` is collective over
the world).
"""

from __future__ import annotations

import dataclasses
import typing

__all__ = ["make_hierarchical_layout", "DpSpLayout", "make_dp_sp_layout",
           "MeshGroups", "join_groups", "join_dp_sp_groups",
           "join_dp_sp_tp_groups"]


def make_hierarchical_layout(nprocs_per_node: int, n_devices: int) -> int:
    """The number of nodes of ``nprocs_per_node`` devices in
    ``n_devices``; the reference's ``ValueError`` when they do not
    divide."""
    if nprocs_per_node < 1:
        raise ValueError(f"nprocs_per_node must be >= 1, got "
                         f"{nprocs_per_node}")
    if n_devices % nprocs_per_node:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"nprocs_per_node={nprocs_per_node}")
    return n_devices // nprocs_per_node


@dataclasses.dataclass(frozen=True)
class DpSpLayout:
    """``world`` processes as ``dp`` replicas x ``pp`` pipeline stages x
    ``ep`` expert shards x ``sp`` sequence shards x ``tp`` tensor shards,
    row-major: process ``p`` is ``(replica, e, shard, t)``
    (:meth:`grid`) of stage :meth:`stage`."""

    world: int
    sp: int
    tp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def dp(self) -> int:
        return self.world // (self.pp * self.ep * self.sp * self.tp)

    def grid(self, proc: int) -> tuple[int, int, int, int]:
        """``(replica, e, shard, t)`` of process ``proc``."""
        proc = int(proc)
        return (proc // (self.pp * self.ep * self.sp * self.tp),
                (proc // (self.sp * self.tp)) % self.ep,
                (proc // self.tp) % self.sp, proc % self.tp)

    def stage(self, proc: int) -> int:
        """The pipeline stage of process ``proc``."""
        return (int(proc) // (self.ep * self.sp * self.tp)) % self.pp

    def index(self, proc: int) -> tuple[int, int, int]:
        """``(replica, shard, t)`` of process ``proc``."""
        replica, _, shard, t = self.grid(proc)
        return replica, shard, t

    def place(self, proc: int) -> tuple[int, int]:
        """``(replica, shard)`` of process ``proc``."""
        return self.index(proc)[:2]

    def proc(self, replica: int, shard: int, t: int = 0, e: int = 0,
             s: int = 0) -> int:
        """The process holding tp shard ``t`` of sequence shard ``shard``
        of expert shard ``e`` of stage ``s`` of replica ``replica``."""
        return ((((replica * self.pp + s) * self.ep + e) * self.sp + shard)
                * self.tp + t)

    def tp_members(self, replica: int, shard: int = 0, e: int = 0,
                   s: int = 0) -> list[int]:
        """The processes of one ``(replica, s, e, shard)``'s tensor
        shards, in tp order."""
        return [self.proc(replica, shard, t, e, s) for t in range(self.tp)]

    def sp_members(self, replica: int, t: int = 0, e: int = 0,
                   s: int = 0) -> list[int]:
        """The processes of replica ``replica``'s sequence ring at tp
        shard ``t``, expert shard ``e`` and stage ``s``, in shard
        order."""
        return [self.proc(replica, i, t, e, s) for i in range(self.sp)]

    def ep_members(self, replica: int, shard: int = 0, t: int = 0,
                   s: int = 0) -> list[int]:
        """The processes of replica ``replica``'s expert shards at
        ``(s, shard, t)``, in ep order."""
        return [self.proc(replica, shard, t, e, s) for e in range(self.ep)]

    def pp_members(self, replica: int, e: int = 0, shard: int = 0,
                   t: int = 0) -> list[int]:
        """The processes of replica ``replica``'s stages at ``(e, shard,
        t)``, in stage order."""
        return [self.proc(replica, shard, t, e, s) for s in range(self.pp)]

    def dp_members(self, shard: int, t: int = 0, e: int = 0,
                   s: int = 0) -> list[int]:
        """The processes holding ``(s, e, shard, t)``, in replica (gossip
        rank) order."""
        return [self.proc(r, shard, t, e, s) for r in range(self.dp)]

    def all_dp_members(self) -> list[list[int]]:
        """Every dp group's members, one group an ``(s, e, shard, t)``."""
        return [self.dp_members(i, t, e, s) for s in range(self.pp)
                for e in range(self.ep) for i in range(self.sp)
                for t in range(self.tp)]


def make_dp_sp_layout(world: int, sp: int, tp: int = 1,
                      ep: int = 1, pp: int = 1) -> DpSpLayout:
    """The ``(gossip, pipe, ep, seq, tp)`` layout of ``world``
    processes; the reference's ``ValueError`` when ``sp·tp·ep·pp`` does
    not divide them."""
    for name, n in (("sp", sp), ("tp", tp), ("ep", ep), ("pp", pp)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    if world % (sp * tp * ep * pp):
        raise ValueError(f"world_size {world} not divisible by sp*tp*ep*pp "
                         f"{sp * tp * ep * pp}")
    return DpSpLayout(int(world), int(sp), int(tp), int(ep), int(pp))


class MeshGroups(typing.NamedTuple):
    """A process's groups of each kind (None where the axis is 1, the dp
    and sp groups always)."""

    tp: typing.Any
    sp: typing.Any
    dp: typing.Any
    ep: typing.Any
    pp: typing.Any = None


def join_groups(layout: DpSpLayout, proc: int) -> MeshGroups:
    """The groups of process ``proc``: every ``(replica, s, e, shard)``'s
    tp group (none at ``tp == 1``), then every ``(replica, s, e, t)``'s
    sp group, then every ``(s, e, shard, t)``'s dp group, then every
    ``(replica, s, shard, t)``'s ep group (none at ``ep == 1``), then
    every ``(replica, e, shard, t)``'s pipe group (none at ``pp == 1``),
    made in this order by every process of the world."""
    import torch.distributed as dist

    n = layout
    cells = [(r, s, e, i, t) for r in range(n.dp) for s in range(n.pp)
             for e in range(n.ep) for i in range(n.sp) for t in range(n.tp)]
    tp_groups = ({(r, s, e, i): dist.new_group(n.tp_members(r, i, e, s))
                  for r, s, e, i, t in cells if t == 0} if n.tp > 1
                 else None)
    sp_groups = {(r, s, e, t): dist.new_group(n.sp_members(r, t, e, s))
                 for r, s, e, i, t in cells if i == 0}
    dp_groups = {(s, e, i, t): dist.new_group(n.dp_members(i, t, e, s))
                 for r, s, e, i, t in cells if r == 0}
    ep_groups = ({(r, s, i, t): dist.new_group(n.ep_members(r, i, t, s))
                  for r, s, e, i, t in cells if e == 0} if n.ep > 1
                 else None)
    pp_groups = ({(r, e, i, t): dist.new_group(n.pp_members(r, e, i, t))
                  for r, s, e, i, t in cells if s == 0} if n.pp > 1
                 else None)
    replica, e, shard, t = n.grid(proc)
    s = n.stage(proc)
    return MeshGroups(
        None if tp_groups is None else tp_groups[replica, s, e, shard],
        sp_groups[replica, s, e, t], dp_groups[s, e, shard, t],
        None if ep_groups is None else ep_groups[replica, s, shard, t],
        None if pp_groups is None else pp_groups[replica, e, shard, t])


def join_dp_sp_tp_groups(layout: DpSpLayout, proc: int):
    """``(tp_group, sp_group, dp_group)`` of process ``proc``
    (:func:`join_groups` at ``ep == 1``)."""
    return tuple(join_groups(layout, proc))[:3]


def join_dp_sp_groups(layout: DpSpLayout, proc: int):
    """``(sp_group, dp_group)`` of process ``proc`` (the groups of
    :func:`join_dp_sp_tp_groups` at ``tp == 1``)."""
    return join_dp_sp_tp_groups(layout, proc)[1:]
