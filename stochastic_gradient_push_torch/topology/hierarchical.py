"""Two-level hierarchical gossip: an exact grouped mean inside each slice
and sparse delegate gossip across slices.

A copy of ``stochastic_gradient_push_tpu/topology/hierarchical.py``
(numpy only; graph 6 of the registry).  The tables it produces are the
reference's, entry for entry (``tests/test_torch_hierarchical.py``).

Each gossip round composes two sub-phases:

1. **inter** — the first ``dcn_fanout`` ranks of each slice (its
   *delegates*) send a push-sum share to the matching delegates of
   ``peers_per_itr`` other slices, rotating through an exponential
   schedule over slices; everyone else maps to itself at weight 0.
   The port's collectives run it as one flat round over
   :attr:`HierarchicalSchedule.inter_schedule` (through the gossip
   kernels on the kernel lane).
2. **intra** — an *exact* mean inside every slice: one grouped mean on
   the transport (``parallel/collectives.py::intra_average``).  The
   tables represent it as ``slice_size - 1`` rotate-within-slice
   permutations at uniform ``1/slice_size`` weight, so the dense mixing
   matrices the verifier builds are the matrices the round applies.

Both sub-phases are column-stochastic, so push-sum mass is conserved by
the composed round.  Per round, only ``num_slices x dcn_fanout x
peers_per_itr`` messages cross slices.  ``dcn_fanout`` (default
``max(1, slice_size // 4)``) trades slice-level mixing speed against
cross-slice volume.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np

from .graphs import GraphTopology, NPeerDynamicDirectedExponentialGraph
from .mixing import MixingStrategy, UniformMixing
from .schedule import GossipSchedule

__all__ = ["HierarchicalGraph", "HierarchicalSchedule",
           "default_slice_size"]


def default_slice_size(world_size: int) -> int:
    """Pick the slice decomposition for ``world_size`` ranks.

    Prefers few, large slices (the shape of real multi-slice pods: big
    ICI domains, a handful of DCN actors): the smallest divisor ``s`` of
    ``world_size`` with ``s >= ceil(sqrt(world_size))`` that still leaves
    at least two slices.  E.g. 64 → 8×8, 32 → 8 ranks × 4 slices,
    8 → 4 ranks × 2 slices, 48 → 8 ranks × 6 slices.
    """
    if world_size < 4:
        raise ValueError(
            f"world_size must be >= 4 for hierarchical gossip (at least "
            f"two slices of two ranks); got {world_size}")
    root = math.isqrt(world_size - 1) + 1  # ceil(sqrt(world_size))
    for s in range(root, world_size // 2 + 1):
        if world_size % s == 0:
            return s
    raise ValueError(
        f"world_size={world_size} unsupported for hierarchical gossip: "
        "no slice decomposition with >= 2 slices of >= 2 ranks")


@dataclasses.dataclass(frozen=True)
class HierarchicalSchedule(GossipSchedule):
    """A :class:`GossipSchedule` whose phases alternate inter/intra.

    The inherited table fields hold the *effective* two-level schedule —
    ``num_phases = 2 × rounds_per_cycle`` phases (even = inter-slice
    leader gossip, odd = intra-slice exact average), padded to a uniform
    ``peers_per_itr`` table width with zero-weight identity sub-rounds —
    so the verifier, the spectral-gap machinery, and the numpy mixing
    simulator treat it exactly like any flat schedule.  The extra fields
    tell the round (``parallel/collectives.py``) and the planner's cost
    model about the two-level structure.
    """

    slice_size: int = 0
    num_slices: int = 0
    inter_ppi: int = 0           # delegate out-degree per round (user ppi)
    dcn_fanout: int = 0          # delegates per slice (cross-slice rails)
    rounds_per_cycle: int = 0    # rounds per rotation cycle
    # one entry per table phase: "inter" | "intra"
    phase_kinds: tuple = ()

    @cached_property
    def inter_schedule(self) -> GossipSchedule:
        """Compact tables for the inter phases only (no padding): what
        the delegate round actually executes."""
        return GossipSchedule(
            perms=np.ascontiguousarray(self.perms[0::2, :self.inter_ppi]),
            self_weight=np.ascontiguousarray(self.self_weight[0::2]),
            edge_weights=np.ascontiguousarray(
                self.edge_weights[0::2, :self.inter_ppi]),
            regular=False, world_size=self.world_size,
            peers_per_itr=self.inter_ppi,
            num_phases=self.rounds_per_cycle)

    @cached_property
    def slice_groups(self) -> tuple:
        """The rank groups of the intra-slice mean."""
        s = self.slice_size
        return tuple(tuple(range(j * s, (j + 1) * s))
                     for j in range(self.num_slices))


class HierarchicalGraph(GraphTopology):
    """Two-level topology: slices of ``slice_size`` ranks, exact inside,
    sparse leader gossip across.

    Args:
      world_size: total gossip ranks; must decompose into >= 2 slices of
        >= 2 ranks.
      peers_per_itr: delegate out-degree per round (inter-slice fan-out —
        the DCN communication budget; intra-slice exchange is always the
        full exact average).
      slice_size: ranks per slice (must divide ``world_size``); None
        picks :func:`default_slice_size`.  Slices are contiguous rank
        blocks — rank ``r`` is in slice ``r // slice_size`` and its
        delegates are the slice's first ``dcn_fanout`` ranks.
      dcn_fanout: cross-slice senders per slice; None picks
        ``max(1, slice_size // 4)`` (see the module docstring for the
        mixing-speed / DCN-volume tradeoff).
    """

    # bilateral pairing has no meaning for a two-level schedule: delegates
    # are not interchangeable with members (schedule.build_pairing_schedule
    # refuses with an unsupported-configuration error)
    supports_pairing = False

    def __init__(self, world_size: int, peers_per_itr: int = 1,
                 slice_size: int | None = None,
                 dcn_fanout: int | None = None):
        if peers_per_itr < 1:
            raise ValueError("peers_per_itr must be >= 1")
        world_size = int(world_size)
        if slice_size is None:
            slice_size = default_slice_size(world_size)
        slice_size = int(slice_size)
        if world_size < 4:
            raise ValueError(
                f"world_size must be >= 4 for hierarchical gossip (at "
                f"least two slices of two ranks); got {world_size}")
        if slice_size < 2 or world_size % slice_size \
                or world_size // slice_size < 2:
            raise ValueError(
                f"slice_size={slice_size} unsupported for "
                f"world_size={world_size}: need >= 2 contiguous slices "
                "of >= 2 ranks each")
        if dcn_fanout is None:
            dcn_fanout = max(1, slice_size // 4)
        if not 1 <= dcn_fanout <= slice_size:
            raise ValueError(
                f"dcn_fanout must be >= 1 and <= slice_size="
                f"{slice_size}; got {dcn_fanout}")
        self.world_size = world_size
        self.peers_per_itr = int(peers_per_itr)
        self.slice_size = slice_size
        self.dcn_fanout = int(dcn_fanout)
        self.num_slices = world_size // slice_size
        # slice-level rotation: the same exponential schedule flat gossip
        # uses, one level up (ppi beyond its phone book raises the usual
        # unsupported-configuration error)
        self.slice_graph = NPeerDynamicDirectedExponentialGraph(
            self.num_slices, peers_per_itr=self.peers_per_itr)
        # informational phone book (debugging / repr); the schedule is
        # built by compile_schedule, not by phone-book rotation
        s = slice_size
        self.phone_book = [
            [r for r in range((rank // s) * s, (rank // s + 1) * s)
             if r != rank] for rank in range(world_size)]
        for j in range(self.num_slices):
            for i in range(self.dcn_fanout):
                self.phone_book[j * s + i] += [
                    p * s + i for p in self.slice_graph.phone_book[j]]
        self._book_len = len(self.phone_book[0])

    # -- topology properties ----------------------------------------------

    def is_regular_graph(self) -> bool:
        return False   # leaders and members have different degrees

    def is_bipartite_graph(self) -> bool:
        return False

    def is_dynamic_graph(self) -> bool:
        return True

    @property
    def num_phases(self) -> int:
        """Table phases per cycle (2 × rounds: inter + intra each round)."""
        return 2 * self.slice_graph.num_phases

    # -- schedule compilation ---------------------------------------------

    def compile_schedule(self, mixing: MixingStrategy | None = None
                         ) -> HierarchicalSchedule:
        """Compile the two-level schedule (the :func:`~.schedule.
        build_schedule` hook).

        ``mixing`` shapes the *delegate* weights only: a delegate keeps
        ``self_weight`` of its mass and spreads the rest across its
        ``peers_per_itr`` inter-slice messages.  Uniform mixing keeps a
        delegate's **slice share** ``1/slice_size`` — after the intra
        allreduce a delegate's value is the slice mean, so holding more
        of itself only slows cross-slice diffusion (the slice-level
        contraction per round is ``dcn_fanout × w / slice_size``, capped
        by what the delegates can send).  ``SelfWeightedMixing(alpha)``
        makes the kept share an explicit knob.  Non-delegates keep
        weight 1 during the inter phase, and the intra phase is always
        the exact ``1/slice_size`` average — it is an allreduce, not a
        knob.
        """
        mixing = mixing or UniformMixing()
        n, s, m = self.world_size, self.slice_size, self.num_slices
        ppi, Q = self.peers_per_itr, self.slice_graph.num_phases
        f = self.dcn_fanout
        width = max(s - 1, ppi)
        if mixing.is_uniform():
            lo_all = np.full((n,), 1.0 / s, dtype=np.float64)
            ew_all = np.full((ppi, n), (1.0 - 1.0 / s) / ppi,
                             dtype=np.float64)
        else:
            # generic per-rank weight tables from the strategy; only the
            # delegate columns are consumed (column-stochastic per rank
            # by the strategy's own contract)
            lo_all, ew_all = mixing.weights(self, 0)
            lo_all = np.asarray(lo_all, dtype=np.float64)
            ew_all = np.asarray(ew_all, dtype=np.float64)

        ident = np.arange(n, dtype=np.int32)
        perms = np.tile(ident, (2 * Q, width, 1))
        self_w = np.ones((2 * Q, n), dtype=np.float64)
        edge_w = np.zeros((2 * Q, width, n), dtype=np.float64)

        base = (np.arange(n) // s) * s
        offset = np.arange(n) - base
        for q in range(Q):
            inter = 2 * q
            for j in range(m):
                peer_slices = self.slice_graph.out_peers(j, q)
                for r in range(f):   # parallel delegate rails
                    src = j * s + r
                    self_w[inter, src] = lo_all[src]
                    for i, peer_slice in enumerate(peer_slices):
                        perms[inter, i, src] = peer_slice * s + r
                        edge_w[inter, i, src] = ew_all[i, src]
            intra = 2 * q + 1
            self_w[intra, :] = 1.0 / s
            for d in range(1, s):
                perms[intra, d - 1, :] = base + (offset + d) % s
                edge_w[intra, d - 1, :] = 1.0 / s

        totals = self_w + edge_w.sum(axis=1)
        if np.abs(totals - 1.0).max() > 1e-12:
            raise ValueError(
                f"hierarchical mixing weights have column sums deviating "
                f"by {np.abs(totals - 1.0).max():.2e} from 1 "
                "(column-stochasticity violated)")
        return HierarchicalSchedule(
            perms=perms, self_weight=self_w, edge_weights=edge_w,
            regular=False, world_size=n, peers_per_itr=width,
            num_phases=2 * Q, slice_size=s, num_slices=m,
            inter_ppi=ppi, dcn_fanout=f, rounds_per_cycle=Q,
            phase_kinds=("inter", "intra") * Q)

    # -- schedule extraction (informational API) ---------------------------

    @cached_property
    def _uniform_schedule(self) -> HierarchicalSchedule:
        return self.compile_schedule(UniformMixing())

    @property
    def all_phase_permutations(self) -> np.ndarray:
        return self._uniform_schedule.perms

    def phase_permutation(self, phase: int) -> np.ndarray:
        return self.all_phase_permutations[phase % self.num_phases]

    def out_peers(self, rank: int, phase: int) -> tuple[int, ...]:
        """Ranks ``rank`` actually sends mass to at table ``phase``
        (zero-weight padding edges excluded)."""
        sched = self._uniform_schedule
        p = phase % sched.num_phases
        return tuple(int(sched.perms[p, i, rank])
                     for i in range(sched.peers_per_itr)
                     if sched.edge_weights[p, i, rank] > 0.0)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(world_size={self.world_size}, "
                f"peers_per_itr={self.peers_per_itr}, "
                f"slice_size={self.slice_size}, "
                f"num_slices={self.num_slices}, "
                f"dcn_fanout={self.dcn_fanout}, "
                f"rounds_per_cycle={self.slice_graph.num_phases})")
