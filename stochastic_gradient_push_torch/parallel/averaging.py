"""Standalone distributed averaging: gossip without a model.

Port of ``stochastic_gradient_push_tpu/parallel/averaging.py``, the
original README's use of a gossiper "just for distributed averaging":
hand :func:`push_sum_average` a tree (dicts, lists and tuples of tensors,
``utils/flatten.py``'s order) whose leaves carry a leading rank dim, a
transport and a schedule, and get back every rank's de-biased estimate
of the mean.  The rounds are ``parallel/collectives.py::gossip_round``'s
plain push-sum rounds (no gossip kernel: the reference runs its XLA
round), with the push-sum weight an exact float32 leaf beside the
values, so irregular mixing still converges to the exact mean.  The
leaves ride the rounds raveled into one ``[R, N]`` buffer per dtype, as
the original flattens a gossip message (the round is elementwise, so
the values are the per-leaf round's bit for bit, in a few launches a
round instead of a few per leaf); the results are views of it.  On a
``StackedTransport`` every rank is a row of this process; on a
``DistTransport`` each process passes its own rows.

Example (world 8, stacked)::

    from stochastic_gradient_push_torch.parallel.averaging import (
        consensus_error, push_sum_average)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)

    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(8))
    tree = {"w": torch.randn(8, 3, 2), "b": torch.randn(8, 5)}
    out = push_sum_average(tree, StackedTransport(8), sched, rounds=50)
    consensus_error(out)   # ~1e-7: every row holds the mean
"""

from __future__ import annotations

import numpy as np
import torch

from ..topology.schedule import GossipSchedule
from ..utils.flatten import (flat_by_dtype, tree_leaves, tree_unflatten,
                             unflatten_by_dtype)
from .collectives import gossip_round

__all__ = ["push_sum_average", "consensus_error"]


def push_sum_average(tree, transport, schedule: GossipSchedule, rounds: int,
                     start_phase: int = 0):
    """``rounds`` push-sum rounds over ``transport`` at phases
    ``start_phase, start_phase + 1, ...``, then the de-biased values
    ``x / w``: a tree of ``tree``'s structure, every row its rank's
    estimate of the mean."""
    if schedule.world_size != transport.world_size:
        raise ValueError(
            f"schedule was built for world_size={schedule.world_size} but "
            f"the transport holds world {transport.world_size}")
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]
    if not leaves:
        return tree_unflatten(tree, [])
    groups = flat_by_dtype(leaves)
    flats = [flat for flat, _ in groups]
    weight = torch.ones(flats[0].shape[0], dtype=torch.float32,
                        device=flats[0].device)
    for k in range(rounds):
        *flats, weight = gossip_round([*flats, weight], start_phase + k,
                                      schedule, transport)
    out = list(leaves)
    for flat, (_, index) in zip(flats, groups):
        unflatten_by_dtype(out, leaves,
                           flat / weight.to(flat.dtype)[:, None], index)
    return tree_unflatten(tree, out)


def consensus_error(tree) -> float:
    """Max absolute deviation from the rank mean over every leaf
    (leading rank dim): how far the ranks are from consensus.  Computed
    on the host in the leaves' dtype, as the reference's numpy does."""
    leaves = [torch.as_tensor(leaf).detach().cpu().numpy()
              for leaf in tree_leaves(tree)]
    world = leaves[0].shape[0]
    flat = np.concatenate([a.reshape(world, -1) for a in leaves], axis=1)
    return float(np.abs(flat - flat.mean(axis=0, keepdims=True)).max())
