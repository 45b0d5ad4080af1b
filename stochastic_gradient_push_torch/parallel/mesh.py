"""Layouts of a world: nodes of ``nprocs_per_node`` devices, and the
``(gossip, seq, tp)`` grid of replicas, sequence shards and tensor
shards.

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
the reference's ``(gossip, seq, tp)`` grid in its device order
(``make_dp_sp_tp_mesh``, ``stochastic_gradient_push_tpu/train/lm.py:72-76``):
process ``p`` is ``(replica, shard, t) = (p // (sp·tp), (p // tp) % sp,
p % tp)``, tp shard ``t`` of sequence shard ``shard`` of gossip replica
``replica``.  At ``tp == 1`` that is the ``(gossip, seq)`` order of
``make_dp_sp_mesh``.  The ``tp`` processes of one ``(replica, shard)``
form its **tp group** (the Megatron reductions, ``parallel/tp.py``); a
replica's ``sp`` processes of one ``t`` form its **sp group** (ring
shifts, the mean of loss and gradients over shards); the ``dp``
processes of one ``(shard, t)`` index form its **dp group** (the gossip
round and every mean over replicas); agreement (signals, the resume
point) stays on the world.  :func:`join_dp_sp_tp_groups` makes every
group of the three kinds, in one order in every process (``new_group``
is collective over the world).
"""

from __future__ import annotations

import dataclasses

__all__ = ["make_hierarchical_layout", "DpSpLayout", "make_dp_sp_layout",
           "join_dp_sp_groups", "join_dp_sp_tp_groups"]


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
    """``world`` processes as ``dp`` replicas x ``sp`` sequence shards x
    ``tp`` tensor shards, row-major: process ``p`` is ``(replica, shard,
    t) = (p // (sp·tp), (p // tp) % sp, p % tp)``."""

    world: int
    sp: int
    tp: int = 1

    @property
    def dp(self) -> int:
        return self.world // (self.sp * self.tp)

    def index(self, proc: int) -> tuple[int, int, int]:
        """``(replica, shard, t)`` of process ``proc``."""
        proc = int(proc)
        return (proc // (self.sp * self.tp), (proc // self.tp) % self.sp,
                proc % self.tp)

    def place(self, proc: int) -> tuple[int, int]:
        """``(replica, shard)`` of process ``proc``."""
        return self.index(proc)[:2]

    def proc(self, replica: int, shard: int, t: int = 0) -> int:
        """The process holding tp shard ``t`` of sequence shard ``shard``
        of replica ``replica``."""
        return (replica * self.sp + shard) * self.tp + t

    def tp_members(self, replica: int, shard: int = 0) -> list[int]:
        """The processes of one ``(replica, shard)``'s tensor shards, in
        tp order."""
        return [self.proc(replica, shard, t) for t in range(self.tp)]

    def sp_members(self, replica: int, t: int = 0) -> list[int]:
        """The processes of replica ``replica``'s sequence ring at tp
        shard ``t``, in shard order."""
        return [self.proc(replica, i, t) for i in range(self.sp)]

    def dp_members(self, shard: int, t: int = 0) -> list[int]:
        """The processes holding ``(shard, t)``, in replica (gossip rank)
        order."""
        return [self.proc(r, shard, t) for r in range(self.dp)]


def make_dp_sp_layout(world: int, sp: int, tp: int = 1) -> DpSpLayout:
    """The ``(gossip, seq, tp)`` layout of ``world`` processes; the
    reference's ``ValueError`` when ``sp·tp`` does not divide them."""
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if world % (sp * tp):
        raise ValueError(f"world_size {world} not divisible by sp*tp*ep*pp "
                         f"{sp * tp}")
    return DpSpLayout(int(world), int(sp), int(tp))


def join_dp_sp_tp_groups(layout: DpSpLayout, proc: int):
    """``(tp_group, sp_group, dp_group)`` of process ``proc``: every
    ``(replica, shard)``'s tp group (none at ``tp == 1``), then every
    ``(replica, t)``'s sp group, then every ``(shard, t)``'s dp group,
    made in this order by every process of the world."""
    import torch.distributed as dist

    n = layout
    tp_groups = ({(r, i): dist.new_group(n.tp_members(r, i))
                  for r in range(n.dp) for i in range(n.sp)}
                 if n.tp > 1 else None)
    sp_groups = {(r, t): dist.new_group(n.sp_members(r, t))
                 for r in range(n.dp) for t in range(n.tp)}
    dp_groups = {(i, t): dist.new_group(n.dp_members(i, t))
                 for i in range(n.sp) for t in range(n.tp)}
    replica, shard, t = n.index(proc)
    return (None if tp_groups is None else tp_groups[replica, shard],
            sp_groups[replica, t], dp_groups[shard, t])


def join_dp_sp_groups(layout: DpSpLayout, proc: int):
    """``(sp_group, dp_group)`` of process ``proc`` (the groups of
    :func:`join_dp_sp_tp_groups` at ``tp == 1``)."""
    return join_dp_sp_tp_groups(layout, proc)[1:]
