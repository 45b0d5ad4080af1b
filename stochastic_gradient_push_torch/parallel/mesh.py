"""A world of devices split into nodes of ``nprocs_per_node`` devices.

Counterpart of ``stochastic_gradient_push_tpu/parallel/mesh.py``'s
``make_hierarchical_mesh``.  The port has no device mesh: a
rank-stacked tensor's leading dim is its rank axis, and the batch's
rows are devices in the reference's mesh-flat order, device row ``d =
node * L + l``.  The gossip runs between the nodes and the train step
averages gradients, BatchNorm statistics and metrics exactly over a
node's ``L`` rows (``train/step.py``'s ``local_axis``), the original's
``nprocs_per_node`` (its ``distributed.py:62-78``).
"""

from __future__ import annotations

__all__ = ["make_hierarchical_layout"]


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
