"""Gossip schedules: topology × mixing → static permutation tables.

A copy of the flat part of ``stochastic_gradient_push_tpu/topology/
schedule.py`` (numpy only): :class:`GossipSchedule` with
``mixing_matrix`` and :func:`build_schedule` for the phone-book
rotation graphs, and :func:`build_pairing_schedule`, the perfect
matchings of bilateral (AD-PSGD) averaging.  All phases of a
time-varying graph are enumerated ahead of time and frozen into numpy
tables; the port's collectives pick a phase's tables by ``phase %
num_phases`` on the host.

Graphs whose schedule is not phone-book rotation (the hierarchical and
synthesized topologies) provide a ``compile_schedule`` hook and build
their own tables.  Not ported: ``overlap_schedule``, the augmented
OSGP tables the reference's static verifier sweeps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graphs import GraphTopology
from .mixing import MixingStrategy, UniformMixing

__all__ = ["GossipSchedule", "build_schedule", "build_pairing_schedule"]


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
    """Compile ``graph`` + ``mixing`` into a :class:`GossipSchedule`; a
    graph with a ``compile_schedule`` hook (hierarchical, synthesized)
    builds its own."""
    if mixing is None:
        mixing = UniformMixing()
    compile_hook = getattr(graph, "compile_schedule", None)
    if compile_hook is not None:
        return compile_hook(mixing)
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


def build_pairing_schedule(graph: GraphTopology) -> np.ndarray:
    """Perfect-matching schedule for bilateral (AD-PSGD style) averaging.

    Returns int32 ``(num_phases, world_size)`` where ``pairing[p, r]`` is
    the partner of ``r`` at phase ``p``; each row is an involution
    (``pairing[p, pairing[p, r]] == r``).

    For bipartite graphs the matching is derived from the active ranks'
    out-peers (the synchronous counterpart of the active-initiates /
    passive-responds handshake).  For non-bipartite graphs, each hop
    distance ``d`` in the phone book with ``d | n`` and ``n/d`` even
    yields two block matchings (``r <-> r+d`` aligned at 0 and shifted by
    ``d``), deduplicated and sorted as rows.
    """
    n = graph.world_size
    if n == 1:
        return np.zeros((1, 1), dtype=np.int32)
    if not getattr(graph, "supports_pairing", True):
        raise ValueError(
            f"{type(graph).__name__} is unsupported for bilateral "
            "pairing: its ranks are not interchangeable partners")
    if n % 2:
        raise ValueError("bilateral pairing requires an even world size")

    if graph.is_bipartite_graph():
        num_phases = graph.num_phases * graph.peers_per_itr
        pairing = np.empty((num_phases, n), dtype=np.int32)
        for p in range(graph.num_phases):
            for i in range(graph.peers_per_itr):
                row = np.full((n,), -1, dtype=np.int32)
                for r in range(n):
                    if graph.is_passive(r):
                        continue
                    d = graph.out_peers(r, p)[i]
                    if row[r] != -1 or row[d] != -1:
                        raise ValueError(
                            f"phase {p} does not induce a matching")
                    row[r], row[d] = d, r
                if (row < 0).any():
                    raise ValueError(f"phase {p} leaves ranks unpaired")
                pairing[p * graph.peers_per_itr + i] = row
    else:
        # hop distances, forward and backward collapsed to min(d, n - d)
        distances = []
        for peer in graph.phone_book[0]:
            d = min(peer % n, (n - peer) % n)
            if d and d not in distances:
                distances.append(d)
        usable = [d for d in distances if n % d == 0 and (n // d) % 2 == 0]
        if not usable:
            raise ValueError(
                f"{type(graph).__name__}(world_size={n}) has no hop "
                "distance d with d | n and n/d even; no matching schedule "
                "can be derived — use a bipartite graph for bilateral gossip")
        rows = []
        ranks = np.arange(n)
        for d in usable:
            for shift in (0, d):
                blk = (ranks - shift) // d
                row = np.where(blk % 2 == 0, ranks + d, ranks - d) % n
                rows.append(row.astype(np.int32))
        pairing = np.unique(np.stack(rows), axis=0)

    for row in pairing:
        if not np.array_equal(row[row], np.arange(n)):
            raise AssertionError("pairing schedule is not an involution")
    return pairing
