"""Gossip schedules: topology × mixing → static permutation tables.

A copy of the flat part of ``stochastic_gradient_push_tpu/topology/
schedule.py`` (numpy only): :class:`GossipSchedule` with
``mixing_matrix`` and :func:`build_schedule` for the phone-book
rotation graphs.  All phases of a time-varying graph are enumerated
ahead of time and frozen into numpy tables; the port's collectives pick
a phase's tables by ``phase % num_phases`` on the host.

Not ported yet: ``overlap_schedule`` (OSGP), the ``compile_schedule``
hook of the hierarchical and synthesized topologies, and
``build_pairing_schedule`` (AD-PSGD).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graphs import GraphTopology
from .mixing import MixingStrategy, UniformMixing

__all__ = ["GossipSchedule", "build_schedule"]


@dataclasses.dataclass(frozen=True)
class GossipSchedule:
    """Frozen gossip plan for one (topology, mixing, peers_per_itr) triple.

    Attributes:
      perms: int32 ``(num_phases, peers_per_itr, world_size)``;
        ``perms[p, i, src]`` = destination of ``src``'s i-th message in
        phase ``p``.  Every row is a permutation.
      self_weight: float64 ``(num_phases, world_size)`` — per-rank weight
        kept locally.
      edge_weights: float64 ``(num_phases, peers_per_itr, world_size)`` —
        per-rank weight applied to each outgoing message.
      regular: whether mixing is regular (push-sum weight stays 1 across a
        complete synchronous round).
      world_size / peers_per_itr / num_phases: static ints.
    """

    perms: np.ndarray
    self_weight: np.ndarray
    edge_weights: np.ndarray
    regular: bool
    world_size: int
    peers_per_itr: int
    num_phases: int

    def mixing_matrix(self, phase: int) -> np.ndarray:
        """Dense column-stochastic mixing matrix W for ``phase``.

        ``x_new[dst] = sum_src W[dst, src] * x[src]`` — used by tests,
        never by the collectives.
        """
        n = self.world_size
        w = np.zeros((n, n), dtype=np.float64)
        p = phase % self.num_phases
        for src in range(n):
            w[src, src] += self.self_weight[p, src]
            for i in range(self.peers_per_itr):
                w[self.perms[p, i, src], src] += \
                    self.edge_weights[p, i, src]
        return w


def build_schedule(graph: GraphTopology,
                   mixing: MixingStrategy | None = None) -> GossipSchedule:
    """Compile ``graph`` + ``mixing`` into a :class:`GossipSchedule`."""
    if mixing is None:
        mixing = UniformMixing()
    if getattr(graph, "compile_schedule", None) is not None:
        raise NotImplementedError(
            f"{type(graph).__name__} compiles its own schedule "
            "(hierarchical / synthesized rounds); the port has the flat "
            "phone-book graphs only so far")
    if graph.world_size == 1:
        ppi = graph.peers_per_itr
        return GossipSchedule(
            perms=np.zeros((1, ppi, 1), dtype=np.int32),
            self_weight=np.ones((1, 1), dtype=np.float64),
            edge_weights=np.zeros((1, ppi, 1), dtype=np.float64),
            regular=True, world_size=1, peers_per_itr=ppi, num_phases=1)
    num_phases = graph.num_phases
    n = graph.world_size
    perms = graph.all_phase_permutations
    self_w = np.empty((num_phases, n), dtype=np.float64)
    edge_w = np.empty((num_phases, graph.peers_per_itr, n),
                      dtype=np.float64)
    for p in range(num_phases):
        lo, ew = mixing.weights(graph, p)
        self_w[p] = lo
        edge_w[p] = ew
        totals = lo + ew.sum(axis=0)
        if np.abs(totals - 1.0).max() > 1e-12:
            raise ValueError(
                f"mixing weights at phase {p} have column sums {totals}, "
                "not 1 (column-stochasticity violated)")
    return GossipSchedule(
        perms=perms,
        self_weight=self_w,
        edge_weights=edge_w,
        regular=mixing.is_regular(graph),
        world_size=graph.world_size,
        peers_per_itr=graph.peers_per_itr,
        num_phases=num_phases,
    )
