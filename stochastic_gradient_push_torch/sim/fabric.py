"""Per-phase wall-clock on a priced fabric.

Port of ``stochastic_gradient_push_tpu/sim/fabric.py``;
:func:`payload_bytes_for` prices with the port's
``telemetry.comm.encoded_payload_bytes`` and its wire codecs.

Time in the simulator is *modeled*, and modeled with the planner's own
cost vocabulary so the two never disagree about what is expensive: every
real edge in a phase's tables is one message of ``payload_bytes`` priced
by :meth:`~..planner.interconnect.InterconnectModel.edge_cost` (ICI
torus hops inside a slice, the flat DCN premium across slices), and a
phase completes when the slowest *rank* has shipped all its messages —
ranks transmit concurrently, a rank's own ``peers_per_itr`` sends
serialize.  Hierarchical intra phases (and synthesized psum phases whose
groups sit inside one slice) are priced as what they compile to on a
sliced fabric — a grouped ring-allreduce, ``2·(s−1)/s`` payloads per
member at one ICI hop — mirroring ``planner.scorer.cycle_cost``.

Units: ``edge_cost`` is in abstract link weight (ICI hop = 1 by
default); :data:`SECONDS_PER_COST_BYTE` converts weight × bytes into
seconds at a nominal 1 GB/s per unit link weight, plus a fixed per-phase
:data:`PHASE_LATENCY_S`.  Absolute seconds are nominal; *ratios* (DCN
16× ICI, linear's O(n)-reach edges vs a ring's neighbors) are the
planner's, which is what consensus-vs-wall-clock curve ORDERINGS rest
on.
"""

from __future__ import annotations

import numpy as np

from ..planner.interconnect import UNIFORM, InterconnectModel
from ..telemetry.comm import PS_WEIGHT_BYTES

__all__ = ["FabricModel", "payload_bytes_for", "PHASE_LATENCY_S",
           "SECONDS_PER_COST_BYTE"]

# nominal timing constants: 1 GB/s per unit link weight, 1 µs per phase
# of launch/sync overhead.  Curve orderings are invariant to both.
SECONDS_PER_COST_BYTE = 1e-9
PHASE_LATENCY_S = 1e-6


def payload_bytes_for(d: int, codec=None) -> int:
    """Wire bytes of one rank's message for a ``d``-vector state: the
    encoded payload (``telemetry.encoded_payload_bytes`` — the wire
    codec's element size for multi-element leaves) plus the push-sum
    weight scalar that rides along with every gossip message."""
    from ..telemetry.comm import encoded_payload_bytes

    tree = {"w": np.zeros((1, int(d)), np.float32)}
    return encoded_payload_bytes(tree, world=1, codec=codec) \
        + PS_WEIGHT_BYTES


class FabricModel:
    """Precomputed per-phase wall-clock for one (schedule, fabric,
    payload) triple.  ``tick_time`` is then an O(active ranks) lookup —
    cheap enough to call every simulated round at world 4096."""

    def __init__(self, schedule, interconnect: InterconnectModel | None,
                 payload_bytes: int):
        self.schedule = schedule
        self.model = interconnect or UNIFORM
        self.payload_bytes = int(payload_bytes)
        n = schedule.world_size
        kinds = getattr(schedule, "phase_kinds", None)
        # edge_costs[p][i] — (world,) link weight of each rank's i-th
        # send (0 for padding/loopback); fused[p] — the phase's fixed
        # grouped-collective time when it compiles to one (else None)
        self.edge_costs: list[np.ndarray] = []
        self.fused: list[float | None] = []
        for p in range(schedule.num_phases):
            kind = kinds[p] if kinds is not None else None
            fused = self._fused_time(kind, p)
            self.fused.append(fused)
            if fused is not None:
                self.edge_costs.append(np.zeros((1, n)))
                continue
            perms = np.asarray(schedule.perms[p])
            weights = np.asarray(schedule.edge_weights[p])
            costs = np.zeros_like(weights, dtype=np.float64)
            for i in range(schedule.peers_per_itr):
                for src in range(n):
                    dst = int(perms[i, src])
                    if weights[i, src] <= 0.0 or dst == src:
                        continue
                    costs[i, src] = self.model.edge_cost(src, dst, n)
            self.edge_costs.append(costs)

    def _fused_time(self, kind, p) -> float | None:
        """Grouped-collective phase time, mirroring ``cycle_cost``:
        intra (and slice-local psum) phases on a sliced fabric are one
        ring-allreduce per group — each member ships ``2·(g−1)/g``
        payloads at one ICI hop, members concurrently."""
        s = self.schedule
        if kind == "intra" and self.model.slice_size:
            g = s.slice_size
        elif kind == "psum" and self.model.slice_size and all(
                len({self.model.slice_of(r) for r in grp}) == 1
                for grp in s.phase_groups[p]):
            g = max(len(grp) for grp in s.phase_groups[p])
        else:
            return None
        per_member = 2.0 * (g - 1) / g * self.model.ici_cost
        return PHASE_LATENCY_S + (self.payload_bytes * per_member
                                  * SECONDS_PER_COST_BYTE)

    def tick_time(self, tick: int, keep_row=None) -> float:
        """Seconds one gossip round takes at ``tick``: latency plus the
        slowest rank's serialized sends.  ``keep_row`` (ppi, world)
        zeroes dropped edges — a mass-conserving drop reabsorbs at the
        sender and ships NOTHING, so it costs no wire time."""
        p = tick % self.schedule.num_phases
        if self.fused[p] is not None:
            return self.fused[p]
        costs = self.edge_costs[p]
        if keep_row is not None:
            costs = costs * (np.asarray(keep_row) > 0.0)
        per_rank = costs.sum(axis=0)
        return PHASE_LATENCY_S + (self.payload_bytes
                                  * float(per_rank.max(initial=0.0))
                                  * SECONDS_PER_COST_BYTE)

    def cycle_time(self) -> float:
        """Fault-free seconds for one full rotation cycle."""
        return sum(self.tick_time(p)
                   for p in range(self.schedule.num_phases))
