"""Communication-graph topologies as pure schedule generators.

A copy of ``stochastic_gradient_push_tpu/topology/graphs.py`` (numpy
only; the port keeps its own copy so it never imports the JAX package).
The tables it produces are the same, entry for entry
(``tests/test_torch_topology.py`` holds them ``array_equal``).  Every
phase of a time-varying graph is a static permutation; the port's
collectives (``parallel/collectives.py``) turn it into an index gather
(one process) or ``torch.distributed`` point-to-point calls.

Graph semantics follow the reference classes one-to-one:

* ``DynamicDirectedExponentialGraph``   — graph_manager.py:149-164
* ``NPeerDynamicDirectedExponentialGraph`` — graph_manager.py:167-184
* ``DynamicBipartiteExponentialGraph``  — graph_manager.py:187-215
* ``DynamicDirectedLinearGraph``        — graph_manager.py:218-235
* ``DynamicBipartiteLinearGraph``       — graph_manager.py:238-262
* ``RingGraph``                         — graph_manager.py:265-279
"""

from __future__ import annotations

import math
from functools import cached_property

import numpy as np

__all__ = [
    "GraphTopology",
    "DynamicDirectedExponentialGraph",
    "NPeerDynamicDirectedExponentialGraph",
    "DynamicBipartiteExponentialGraph",
    "DynamicDirectedLinearGraph",
    "DynamicBipartiteLinearGraph",
    "RingGraph",
]


class GraphTopology:
    """Base class for peer-to-peer communication topologies.

    Subclasses implement :meth:`_make_graph` filling ``self.phone_book`` —
    ``phone_book[rank]`` is the ordered list of out-peer ranks that ``rank``
    may send to (mirrors graph_manager.py:58-73, minus the ``Edge`` process
    groups, which a static permutation table replaces).

    Rotation: at phase ``p`` the active out-peers of ``rank`` are
    ``phone_book[rank][(i + p * peers_per_itr) % L]`` for
    ``i in range(peers_per_itr)`` where ``L = len(phone_book[rank])``
    (graph_manager.py:128-133).  Static graphs never rotate
    (gossiper.py:112-118).
    """

    def __init__(self, world_size: int, peers_per_itr: int = 1):
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        if peers_per_itr < 1:
            raise ValueError("peers_per_itr must be >= 1")
        self.world_size = int(world_size)
        self.peers_per_itr = int(peers_per_itr)
        self.phone_book: list[list[int]] = [[] for _ in range(self.world_size)]
        # membership sets mirroring the phone book: dedup in O(1) so
        # dense graphs (linear at pod-farm worlds: O(n) entries per
        # rank) construct in O(n²) total instead of O(n³) list scans
        self._book_sets: list[set[int]] = [set()
                                           for _ in range(self.world_size)]
        if self.world_size > 1:
            self._make_graph()
        del self._book_sets
        self._validate()

    # -- graph construction ------------------------------------------------

    def _make_graph(self) -> None:
        raise NotImplementedError

    def _add_peers(self, rank: int, peers) -> None:
        book, seen = self.phone_book[rank], self._book_sets[rank]
        for peer in peers:
            if peer != rank and peer not in seen:
                seen.add(peer)
                book.append(int(peer))

    def _rotate_forward(self, r: int, p: int) -> int:
        return (r + p) % self.world_size

    def _rotate_backward(self, r: int, p: int) -> int:
        return (r - p) % self.world_size

    def _validate(self) -> None:
        if self.world_size == 1:
            self._book_len = 0
            return
        lens = {len(pb) for pb in self.phone_book}
        if len(lens) != 1:
            raise ValueError(
                f"{type(self).__name__}(world_size={self.world_size}) produced "
                f"non-uniform phone-book lengths {sorted(lens)}; this world "
                "size is unsupported for SPMD scheduling")
        (self._book_len,) = lens
        if self.peers_per_itr > self._book_len:
            raise ValueError(
                f"peers_per_itr={self.peers_per_itr} exceeds phone-book "
                f"length {self._book_len}")

    # -- topology properties ----------------------------------------------

    def is_regular_graph(self) -> bool:
        raise NotImplementedError

    def is_bipartite_graph(self) -> bool:
        raise NotImplementedError

    def is_passive(self, rank: int) -> bool:
        return False

    def is_dynamic_graph(self) -> bool:
        raise NotImplementedError

    # -- schedule extraction ----------------------------------------------

    @property
    def phone_book_len(self) -> int:
        return self._book_len

    @cached_property
    def num_phases(self) -> int:
        """Number of distinct rotation phases before the schedule repeats."""
        if self.world_size == 1 or not self.is_dynamic_graph():
            return 1
        L = self._book_len
        return L // math.gcd(self.peers_per_itr, L)

    def out_peers(self, rank: int, phase: int) -> tuple[int, ...]:
        """Active out-peers of ``rank`` at rotation ``phase``."""
        if self.world_size == 1:
            return ()
        L = self._book_len
        p = (phase % self.num_phases) if self.is_dynamic_graph() else 0
        return tuple(self.phone_book[rank][(i + p * self.peers_per_itr) % L]
                     for i in range(self.peers_per_itr))

    def in_peers(self, rank: int, phase: int) -> tuple[int, ...]:
        """Ranks that send to ``rank`` at ``phase`` (inverse of out_peers)."""
        res = []
        for src in range(self.world_size):
            if src != rank and rank in self.out_peers(src, phase):
                res.append(src)
        return tuple(res)

    def phase_permutation(self, phase: int) -> np.ndarray:
        """Destination table for ``phase``: ``(peers_per_itr, world_size)``.

        ``perm[i, src]`` is the rank that ``src`` sends its *i*-th message to.
        Each row must be a permutation of ``range(world_size)`` — the
        precondition for lowering one gossip sub-round to one permutation
        of the ranks (an index gather, or one send and one receive per
        rank).  All built-in topologies satisfy this because every
        phone book entry is ``rank + d (mod N)`` with an offset ``d`` uniform
        within each parity class.
        """
        if self.world_size == 1:
            return np.zeros((self.peers_per_itr, 1), dtype=np.int32)
        perm = np.empty((self.peers_per_itr, self.world_size), dtype=np.int32)
        for src in range(self.world_size):
            for i, dst in enumerate(self.out_peers(src, phase)):
                perm[i, src] = dst
        for i in range(self.peers_per_itr):
            if len(set(perm[i].tolist())) != self.world_size:
                raise ValueError(
                    f"{type(self).__name__}: phase {phase} sub-round {i} is "
                    "not a permutation; cannot lower to one exchange")
        return perm

    @cached_property
    def all_phase_permutations(self) -> np.ndarray:
        """``(num_phases, peers_per_itr, world_size)`` destination tables."""
        return np.stack([self.phase_permutation(p)
                         for p in range(self.num_phases)])

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(world_size={self.world_size}, "
                f"peers_per_itr={self.peers_per_itr}, "
                f"num_phases={self.num_phases})")


class DynamicDirectedExponentialGraph(GraphTopology):
    """Out-peers at distances ±2^i; rotate one peer pair per step."""

    def _make_graph(self) -> None:
        for rank in range(self.world_size):
            for i in range(0, int(math.log(self.world_size - 1, 2)) + 1
                           if self.world_size > 2 else 1):
                self._add_peers(rank, [self._rotate_forward(rank, 2 ** i),
                                       self._rotate_backward(rank, 2 ** i)])

    def is_regular_graph(self) -> bool: return True
    def is_bipartite_graph(self) -> bool: return False
    def is_dynamic_graph(self) -> bool: return True


class NPeerDynamicDirectedExponentialGraph(GraphTopology):
    """Directed exponential graph generalized to N simultaneous out-peers.

    Default topology of the reference wrapper (distributed.py:107-109).
    """

    def _make_graph(self) -> None:
        k = self.peers_per_itr + 1
        levels = (int(math.log(self.world_size - 1, k)) + 1
                  if self.world_size > 2 else 1)
        for rank in range(self.world_size):
            for i in range(levels):
                for j in range(1, self.peers_per_itr + 1):
                    d = j * (k ** i)
                    self._add_peers(rank, [self._rotate_forward(rank, d)])

    def is_regular_graph(self) -> bool: return True
    def is_bipartite_graph(self) -> bool: return False
    def is_dynamic_graph(self) -> bool: return True


class _BipartiteMixin:
    def is_passive(self, rank: int) -> bool:
        return (rank % 2) == 0

    def _add_bipartite(self, rank: int, f_peer: int, b_peer: int) -> None:
        if not self.is_passive(rank) and (
                self.is_passive(f_peer) and self.is_passive(b_peer)):
            self._add_peers(rank, [f_peer, b_peer])
        elif self.is_passive(rank) and not (
                self.is_passive(f_peer) or self.is_passive(b_peer)):
            self._add_peers(rank, [f_peer, b_peer])


class DynamicBipartiteExponentialGraph(_BipartiteMixin, GraphTopology):
    """Bipartite exponential graph: odd (active) ⇄ even (passive) ranks."""

    def _make_graph(self) -> None:
        if self.world_size % 2:
            raise ValueError("bipartite graphs require an even world size")
        for rank in range(self.world_size):
            for i in range(0, int(math.log(self.world_size - 1, 2)) + 1
                           if self.world_size > 2 else 1):
                d = 1 if i == 0 else 1 + 2 ** i
                self._add_bipartite(rank, self._rotate_forward(rank, d),
                                    self._rotate_backward(rank, d))

    def is_regular_graph(self) -> bool: return True
    def is_bipartite_graph(self) -> bool: return True
    def is_dynamic_graph(self) -> bool: return True


class DynamicDirectedLinearGraph(GraphTopology):
    """Out-peers at every odd distance."""

    def _make_graph(self) -> None:
        for rank in range(self.world_size):
            for i in range(1, self.world_size):
                if i % 2 == 0:
                    continue
                self._add_peers(rank, [self._rotate_forward(rank, i),
                                       self._rotate_backward(rank, i)])

    def is_regular_graph(self) -> bool: return True
    def is_bipartite_graph(self) -> bool: return False
    def is_dynamic_graph(self) -> bool: return True


class DynamicBipartiteLinearGraph(_BipartiteMixin, GraphTopology):
    """Bipartite linear graph: odd ⇄ even ranks at every distance."""

    def _make_graph(self) -> None:
        if self.world_size % 2:
            raise ValueError("bipartite graphs require an even world size")
        for rank in range(self.world_size):
            for i in range(1, self.world_size):
                self._add_bipartite(rank, self._rotate_forward(rank, i),
                                    self._rotate_backward(rank, i))

    def is_regular_graph(self) -> bool: return True
    def is_bipartite_graph(self) -> bool: return True
    def is_dynamic_graph(self) -> bool: return True


class RingGraph(GraphTopology):
    """Static ring: every rank always talks to its two neighbours."""

    def _make_graph(self) -> None:
        for rank in range(self.world_size):
            self._add_peers(rank, [self._rotate_forward(rank, 1),
                                   self._rotate_backward(rank, 1)])

    def is_regular_graph(self) -> bool: return True
    def is_bipartite_graph(self) -> bool: return False
    def is_dynamic_graph(self) -> bool: return False
