"""Layouts of a world: nodes of ``nprocs_per_node`` devices, and the
``(gossip, seq)`` grid of replicas and sequence shards.

Counterpart of ``stochastic_gradient_push_tpu/parallel/mesh.py``'s
``make_hierarchical_mesh`` and of ``make_dp_sp_mesh``
(``stochastic_gradient_push_tpu/train/lm.py:61-63``).  The port has no
device mesh: a rank-stacked tensor's leading dim is its rank axis, and
the batch's rows are devices in the reference's mesh-flat order, device
row ``d = node * L + l``.  The gossip runs between the nodes and the
train step averages gradients, BatchNorm statistics and metrics exactly
over a node's ``L`` rows (``train/step.py``'s ``local_axis``), the
original's ``nprocs_per_node`` (its ``distributed.py:62-78``).

Under ``torchrun``, :class:`DpSpLayout` places the ``P`` processes on
the reference's ``(gossip, seq)`` grid in its device order: process
``p`` holds sequence shard ``p % sp`` of gossip replica ``p // sp``.  A
replica's ``sp`` processes form its **sp group** (ring shifts, the mean
of loss and gradients over shards); the ``dp`` processes of one shard
index form its **dp group** (the gossip round and every mean over
replicas); agreement (signals, the resume point) stays on the world.
:func:`join_dp_sp_groups` makes every group of both kinds, in one order
in every process (``new_group`` is collective over the world).
"""

from __future__ import annotations

import dataclasses

__all__ = ["make_hierarchical_layout", "DpSpLayout", "make_dp_sp_layout",
           "join_dp_sp_groups"]


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
    """``world`` processes as ``dp`` replicas x ``sp`` sequence shards,
    row-major: process ``p`` is ``(replica, shard) = divmod(p, sp)``."""

    world: int
    sp: int

    @property
    def dp(self) -> int:
        return self.world // self.sp

    def place(self, proc: int) -> tuple[int, int]:
        """``(replica, shard)`` of process ``proc``."""
        return divmod(int(proc), self.sp)

    def sp_members(self, replica: int) -> list[int]:
        """The processes of replica ``replica``'s sequence ring, in shard
        order."""
        return [replica * self.sp + i for i in range(self.sp)]

    def dp_members(self, shard: int) -> list[int]:
        """The processes holding shard ``shard``, in replica (gossip rank)
        order."""
        return [r * self.sp + shard for r in range(self.dp)]


def make_dp_sp_layout(world: int, sp: int) -> DpSpLayout:
    """The ``(gossip, seq)`` layout of ``world`` processes; the
    reference's ``ValueError`` when ``sp`` does not divide them."""
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if world % sp:
        raise ValueError(f"world_size {world} not divisible by sp*tp*ep*pp "
                         f"{sp}")
    return DpSpLayout(int(world), int(sp))


def join_dp_sp_groups(layout: DpSpLayout, proc: int):
    """``(sp_group, dp_group)`` of process ``proc``: every replica's sp
    group, then every shard's dp group, made in this order by every
    process of the world."""
    import torch.distributed as dist

    sp_groups = [dist.new_group(layout.sp_members(r))
                 for r in range(layout.dp)]
    dp_groups = [dist.new_group(layout.dp_members(i))
                 for i in range(layout.sp)]
    replica, shard = layout.place(proc)
    return sp_groups[replica], dp_groups[shard]
