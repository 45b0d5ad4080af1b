"""Topology scoring: enumerate, measure, and rank gossip graphs at launch.

SGP's convergence rate degrades as ``1/gap`` of the mixing matrix (Assran
et al. 2018, thm. 1), and the gap is a *launch-time computable* property:
every registered :class:`~..topology.graphs.GraphTopology` compiles to a
finite rotation cycle of column-stochastic matrices whose product's
second-largest eigenvalue modulus is known before the first training step.
This module turns that observation into a ranking:

* **gap** — rotation-cycle spectral gap ``1 − |λ₂|``, computed by the
  analysis layer's :func:`~..analysis.spectral_gap` (public API; the
  planner deliberately does not duplicate the power-of-products
  eigenvalue machinery the verifier already owns);
* **consensus cost** — a per-phase communication model: a cycle of
  ``num_phases`` phases contracts consensus error by ``|λ₂|``, so one
  e-fold of error reduction costs ``num_phases / −ln|λ₂|`` gossip rounds,
  each round sending ``peers_per_itr`` messages per rank.  Exact-consensus
  cycles (gap 1.0, e.g. DynamicBipartiteLinearGraph at even worlds) cost
  exactly one cycle.
* **priced cost** — the same model with each message weighted by the
  :class:`~.interconnect.InterconnectModel`: torus hop distance × ICI
  weight inside a slice, a flat (and typically much larger) DCN weight
  across slices, and hierarchical schedules' intra-slice exact averages
  priced as grouped ring-allreduces (``2·(s−1)/s`` payloads at one ICI
  hop).  This is what lets a two-level
  :class:`~..topology.hierarchical.HierarchicalGraph` — sparse on DCN,
  exact on ICI — outrank flat graphs exactly when the fabric says DCN
  dominates, and lose to them on a uniform fabric.
* **hop cost** — the priced cost evaluated on the :data:`UNIFORM`
  fabric (one 1-D torus, every hop equal): a message to rank ``±d``
  costs ``min(d, n−d)`` link traversals.  Two isomorphic graphs with
  identical spectral gaps can differ several-fold here — a stride-3
  "ring" mixes exactly like the neighbor ring but pays 3 hops per
  message.

Ranking prefers candidates that clear the gap floor, then the cheapest
*priced* consensus under the active interconnect model, then the largest
gap — so a slow-but-connected ring never outranks an exponential graph,
among perfect mixers the one with the shortest cycle wins, and among
equal mixers the one hugging the physical interconnect wins.

Everything here is plain numpy over small ``world × world`` matrices; the
full candidate grid for 64 ranks scores in well under a second on one CPU
core, which is what makes launch-time planning free.

A copy of ``stochastic_gradient_push_tpu/planner/scorer.py`` (numpy
only); the port's analysis layer (``analysis/verifier.py``) gives it the
same gaps and skip rules.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

# shared with the verifier (stable exports) so the planner and the CI
# gate measure gaps identically and skip the exact same cells
from ..analysis import is_unsupported_config, spectral_gap
from ..topology import TOPOLOGY_NAMES, build_schedule, topology_name
from ..topology.hierarchical import HierarchicalGraph
from ..topology.mixing import MixingStrategy, SelfWeightedMixing, UniformMixing
from .interconnect import UNIFORM, InterconnectModel

__all__ = [
    "Candidate",
    "DEFAULT_GAP_FLOOR",
    "DEFAULT_PEER_COUNTS",
    "consensus_cost",
    "cycle_cost",
    "evaluate_candidate",
    "hops_per_round",
    "instantiate_graph",
    "ring_hop_distance",
    "score_candidates",
    "wire_per_round",
]

# gap below which a topology is considered effectively non-mixing at the
# requested world size — the ring-at-pod-scale failure mode (gap 0.0012 at
# world 64 means ~830 gossip rounds per e-fold of consensus error)
DEFAULT_GAP_FLOOR = 0.01

DEFAULT_PEER_COUNTS = (1, 2, 4)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One scored (topology, world, peers_per_itr, mixing) cell."""

    topology: str            # name from topology.TOPOLOGY_NAMES
    world: int
    ppi: int
    mixing: str              # "uniform" or "self-weighted(<alpha>)"
    alpha: float | None      # scalar SelfWeightedMixing alpha, if any
    gap: float               # rotation-cycle spectral gap 1 - |λ₂|
    num_phases: int          # gossip rounds per rotation cycle
    rounds_per_efold: float  # gossip rounds per e-fold of consensus error
    comm_cost: float         # payloads per rank per e-fold (wire volume)
    hop_cost: float = math.inf    # priced cost on the UNIFORM fabric
    priced_cost: float = math.inf  # priced cost, active interconnect model
    ici_per_efold: float = math.inf  # ICI share of priced_cost
    dcn_per_efold: float = 0.0       # DCN share of priced_cost
    slice_size: int | None = None    # hierarchical slice decomposition
    regular: bool = True             # D-PSGD needs doubly-stochastic mixing

    @property
    def graph_class(self):
        """Constructor for the scored topology.  A hierarchical candidate
        binds the slice decomposition it was scored with (like
        ``Plan.graph_class``) so ``graph_class(world, peers_per_itr=ppi)``
        rebuilds exactly the schedule behind this candidate's numbers."""
        cls = TOPOLOGY_NAMES[self.topology]
        if self.slice_size:
            return functools.partial(cls, slice_size=self.slice_size)
        return cls

    def meets(self, floor: float) -> bool:
        return self.gap >= floor

    def to_dict(self) -> dict:
        """JSON-safe summary (checkpoint metadata / report artifacts)."""
        d = dataclasses.asdict(self)
        for k in ("comm_cost", "hop_cost", "priced_cost", "ici_per_efold",
                  "dcn_per_efold", "rounds_per_efold"):
            v = getattr(self, k)
            d[k] = round(v, 3) if math.isfinite(v) else None
        return d


def consensus_cost(gap: float, num_phases: int, ppi: int
                   ) -> tuple[float, float]:
    """(gossip rounds, messages per rank) for one e-fold of consensus
    error, under the per-cycle contraction model described in the module
    docstring."""
    if gap >= 1.0 - 1e-9:
        rounds = float(num_phases)  # exact consensus after one full cycle
    elif gap <= 0.0:
        rounds = math.inf           # cycle does not contract
    else:
        rounds = num_phases / -math.log1p(-gap)
    return rounds, rounds * ppi


def ring_hop_distance(src: int, dst: int, world: int) -> int:
    """ICI link traversals between two gossip ranks laid out on a 1-D
    mesh axis with a wrap-around link (ring/torus): the shorter way
    around, ``min(|d|, n − |d|)``."""
    d = (dst - src) % world
    return min(d, world - d)


def hops_per_round(schedule) -> float:
    """Average ring-hop-weighted messages per rank per gossip round.

    The per-phase mean over ranks of ``Σ_i hop(src → perms[p, i, src])``
    — equals ``peers_per_itr`` when every edge is nearest-neighbor, and
    grows with the graph's reach (an exponential graph's 2^k-distance
    edges are its mixing power AND its wire cost).
    """
    n = schedule.world_size
    if n <= 1:
        return 0.0
    total = 0.0
    for p in range(schedule.num_phases):
        for i in range(schedule.peers_per_itr):
            total += sum(ring_hop_distance(src, int(schedule.perms[p, i,
                                                                   src]), n)
                         for src in range(n))
    return total / (schedule.num_phases * n)


def _rounds_per_cycle(schedule) -> int:
    """Compiled gossip rounds in one rotation cycle (a hierarchical
    round spans two table phases)."""
    return getattr(schedule, "rounds_per_cycle", schedule.num_phases)


def wire_per_round(schedule, wire_fraction: float = 1.0) -> float:
    """Payload-equivalents each rank puts on the wire per gossip round.

    Flat schedules send ``peers_per_itr`` full payloads.  Hierarchical
    rounds send the delegate messages (``num_slices × dcn_fanout ×
    inter_ppi / world`` per rank on average) plus the intra-slice grouped
    allreduce (``2·(s−1)/s`` payloads per rank, the bandwidth-optimal
    ring cost).

    Synthesized schedules (``topology/synthesized.py``) average over the
    cycle's phases: an edge phase ships one payload per *sending* rank
    (sparse delegate-style permutations send far less than one payload
    per rank), a psum phase the grouped ring-allreduce ``2·(g−1)/g``.

    ``wire_fraction`` is the encoded-bytes/full-precision ratio of the
    active wire codec (:meth:`~..parallel.wire.WireCodec.wire_fraction`
    — e.g. 0.266 for int8 at block 64).  It scales the *gossip* payload
    lanes only: grouped exact averages (hierarchical intra, synthesized
    psum phases) never compress, exactly as the collective layer
    compiles them.
    """
    kinds = getattr(schedule, "phase_kinds", None)
    if kinds is None:
        return float(schedule.peers_per_itr) * wire_fraction
    if "inter" in kinds:   # hierarchical two-level round
        s = schedule.slice_size
        inter = (schedule.num_slices * schedule.dcn_fanout
                 * schedule.inter_ppi / schedule.world_size)
        return inter * wire_fraction + 2.0 * (s - 1) / s
    # synthesized composition: per-round mean over the cycle
    n = schedule.world_size
    total = 0.0
    ident = np.arange(n)
    for p, kind in enumerate(kinds):
        if kind == "psum":
            g = len(schedule.phase_groups[p][0])
            total += 2.0 * (g - 1) / g
        else:
            senders = int(np.count_nonzero(
                (np.asarray(schedule.edge_weights[p, 0]) > 0)
                & (np.asarray(schedule.perms[p, 0]) != ident)))
            total += senders / n * wire_fraction
    return total / len(kinds)


def cycle_cost(schedule, model: InterconnectModel,
               wire_fraction: float = 1.0) -> tuple[float, float]:
    """Per-rank mean priced cost of one full rotation cycle.

    Returns ``(ici, dcn)`` in payload-equivalents × link weight.  Every
    non-zero-weight edge in the tables is one message priced by
    :meth:`InterconnectModel.edge_cost`.  When the model declares slice
    structure, hierarchical intra phases are priced as what they compile
    to on such a fabric — a grouped ring-allreduce inside each slice,
    ``2·(s−1)/s`` payloads per rank at one ICI hop.  On a model with no
    slice structure there is no ICI domain to fuse the group collective
    into, so the schedule is priced conservatively as written (its
    ``s−1`` permutation sends at torus distance) — which is why flat
    graphs win the ranking on a uniform fabric and hierarchical wins
    only when the fabric says DCN dominates.

    Synthesized psum phases follow the same rule with their own groups:
    when the model declares slice structure and every group sits inside
    one slice, the phase prices as grouped ring-allreduces
    (``2·(g−1)/g`` payloads per member at one ICI hop); otherwise it is
    priced as its rotate-permutation tables are written.

    ``wire_fraction`` scales every *gossip message* by the active wire
    codec's encoded-bytes ratio; grouped exact averages (hierarchical
    intra, synthesized psum) stay full precision, as compiled.
    """
    n = schedule.world_size
    kinds = getattr(schedule, "phase_kinds", None)
    ici = dcn = 0.0
    for p in range(schedule.num_phases):
        kind = kinds[p] if kinds is not None else None
        if kind == "intra" and model.slice_size:
            s = schedule.slice_size
            ici += model.ici_cost * 2.0 * (s - 1) / s
            continue
        if kind == "psum" and model.slice_size and all(
                len({model.slice_of(r) for r in grp}) == 1
                for grp in schedule.phase_groups[p]):
            for grp in schedule.phase_groups[p]:
                g = len(grp)
                ici += model.ici_cost * 2.0 * (g - 1) / g * g / n
            continue
        # exact-average phases priced as written (no slice structure to
        # fuse into, or a group spanning slices) still ship EXACT
        # payloads — the compiled grouped psum never compresses,
        # whatever the gossip codec does
        frac = 1.0 if kind in ("intra", "psum") else wire_fraction
        perms = schedule.perms[p]
        weights = schedule.edge_weights[p]
        for i in range(schedule.peers_per_itr):
            for src in range(n):
                if weights[i, src] <= 0.0:
                    continue
                dst = int(perms[i, src])
                if dst == src:
                    continue
                cost = frac * model.edge_cost(src, dst, n) / n
                if model.is_cross_slice(src, dst):
                    dcn += cost
                else:
                    ici += cost
    return ici, dcn


def instantiate_graph(graph_class, world: int, ppi: int,
                      interconnect: InterconnectModel | None = None):
    """Build a topology instance, aligning a hierarchical graph's slice
    decomposition with the fabric's when the interconnect declares one."""
    if isinstance(graph_class, type) \
            and issubclass(graph_class, HierarchicalGraph) \
            and interconnect is not None and interconnect.slice_size:
        return graph_class(world, peers_per_itr=ppi,
                           slice_size=interconnect.slice_size)
    return graph_class(world, peers_per_itr=ppi)


def evaluate_candidate(graph_class, world: int, ppi: int,
                       mixing: MixingStrategy | None = None,
                       interconnect: InterconnectModel | None = None,
                       wire_fraction: float = 1.0) -> Candidate | None:
    """Score one cell; ``None`` when the generator refuses the
    configuration (odd world for a bipartite graph, ppi beyond the phone
    book, ...).  ``interconnect`` prices the edges (None = uniform
    fabric, the original ring-hop model); ``wire_fraction`` scales the
    gossip payload lanes by the active wire codec's encoded-bytes ratio
    (1.0 = full precision — rankings under the default are unchanged)."""
    model = interconnect or UNIFORM
    try:
        graph = instantiate_graph(graph_class, world, ppi, model)
        schedule = build_schedule(graph, mixing)
    except ValueError as e:
        if is_unsupported_config(e):
            return None
        raise
    gap = spectral_gap(schedule)
    rpc = _rounds_per_cycle(schedule)
    rounds, _ = consensus_cost(gap, rpc, ppi)
    if math.isfinite(rounds):
        cycles = rounds / rpc
        comm = rounds * wire_per_round(schedule, wire_fraction)
        uniform_costs = cycle_cost(schedule, UNIFORM, wire_fraction)
        hop_cost = cycles * sum(uniform_costs)
        ici_c, dcn_c = (uniform_costs if model is UNIFORM
                        else cycle_cost(schedule, model, wire_fraction))
        ici_e, dcn_e = cycles * ici_c, cycles * dcn_c
        priced = ici_e + dcn_e
    else:
        comm = hop_cost = priced = ici_e = math.inf
        dcn_e = 0.0
    alpha = None
    mix_name = "uniform"
    if isinstance(mixing, SelfWeightedMixing):
        if mixing.alpha.size != 1:
            raise ValueError("planner scores scalar alphas only; per-rank "
                             "alpha tables are a run-layer concern")
        alpha = float(mixing.alpha[0])
        mix_name = f"self-weighted({alpha:.4f})"
    try:
        name = topology_name(graph_class)
    except KeyError:
        # unregistered classes (tests, user extensions) still score; only
        # Plan round-tripping needs a registry name
        name = graph_class.__name__
    return Candidate(topology=name, world=world,
                     ppi=ppi, mixing=mix_name, alpha=alpha, gap=gap,
                     num_phases=rpc,
                     rounds_per_efold=rounds, comm_cost=comm,
                     hop_cost=hop_cost, priced_cost=priced,
                     ici_per_efold=ici_e, dcn_per_efold=dcn_e,
                     slice_size=getattr(schedule, "slice_size", None),
                     regular=bool(schedule.regular))


def score_candidates(world: int,
                     peer_counts=DEFAULT_PEER_COUNTS,
                     floor: float = DEFAULT_GAP_FLOOR,
                     allowed=None,
                     interconnect: InterconnectModel | None = None,
                     wire_fraction: float = 1.0) -> list[Candidate]:
    """Rank every supported (topology × peers_per_itr) cell for ``world``
    under uniform mixing.

    Args:
      world: gossip world size to plan for.
      peer_counts: peers_per_itr values to consider.
      floor: the gap floor used for ranking (floor-clearing candidates
        always outrank the rest).
      allowed: optional iterable of topology names restricting the search.
      interconnect: fabric cost model pricing every edge (None = the
        uniform 1-D torus — the original ring-hop ranking).
      wire_fraction: encoded-bytes ratio of the active wire codec,
        applied to the gossip payload lanes (1.0 = uncompressed).

    Returns candidates sorted best-first: clears-the-floor, then cheapest
    priced consensus under the interconnect model, then largest gap,
    then (name, ppi) for determinism.
    """
    names = sorted(TOPOLOGY_NAMES) if allowed is None else sorted(allowed)
    unknown = [n for n in names if n not in TOPOLOGY_NAMES]
    if unknown:
        raise ValueError(f"unknown topology name(s) {unknown}; registered: "
                         f"{sorted(TOPOLOGY_NAMES)}")
    cands = []
    for name in names:
        for ppi in peer_counts:
            c = evaluate_candidate(TOPOLOGY_NAMES[name], world, ppi,
                                   UniformMixing(),
                                   interconnect=interconnect,
                                   wire_fraction=wire_fraction)
            if c is not None:
                cands.append(c)
    cands.sort(key=lambda c: (not c.meets(floor), c.priced_cost, -c.gap,
                              c.topology, c.ppi))
    return cands
