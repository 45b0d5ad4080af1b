"""Synthesized gossip schedules: searched compositions of edge and psum
phases.

A copy of ``stochastic_gradient_push_tpu/topology/synthesized.py``
(numpy only).  The planner's synthesizer (``planner/synthesize.py``)
searches cycles built from two primitives:

* **edge phases** — one flat round: a permutation of the ranks plus a
  per-rank send weight (self keeps ``1 - send``).  Sparse delegate
  exchanges are permutations that move a few ranks and fix the rest at
  zero weight;
* **psum phases** — one grouped exact mean over equal contiguous rank
  blocks, the hierarchical intra-slice primitive.  The tables represent
  it as ``g - 1`` rotate-permutations at uniform ``1/g`` weight, so the
  dense matrices the verifier builds are the matrices the round applies.

A schedule is *data*: a JSON-safe **spec** (version, world, phase list)
that round-trips through ``Plan.to_dict`` and checkpoint metadata, and
:func:`spec_fingerprint` is the SHA-1 of its normalized JSON.
:class:`SynthesizedGraph` adapts a spec to ``build_schedule`` through the
``compile_schedule`` hook.

Fences, as in the reference: fault injection is rejected (a grouped mean
has no per-edge mask), overlap is rejected (the composition has no
single in-flight form), and bilateral pairing is meaningless.  Wire
codecs apply to edge phases only; the grouped mean is exact.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from .graphs import GraphTopology
from .mixing import MixingStrategy
from .schedule import GossipSchedule

__all__ = ["SynthesizedGraph", "SynthesizedSchedule", "validate_spec",
           "spec_fingerprint", "SPEC_VERSION"]

SPEC_VERSION = 1


def validate_spec(spec, world_size: int | None = None) -> dict:
    """Validate (and normalize) a synthesized-schedule spec.

    A spec is JSON-safe data::

        {"v": 1, "world": N, "phases": [
            {"kind": "edge", "perm": [N ints], "send": [N floats]},
            {"kind": "psum", "group_size": g},      # g | N, contiguous
        ]}

    Edge phases: ``perm`` must be a permutation of ``range(N)`` (the
    bijection precondition of a round, SGPV101) and ``send[r] ∈ [0, 1]``
    is rank ``r``'s outgoing weight (self keeps ``1 − send[r]``, so
    every column sums to 1 by construction, SGPV102).  Self-edges are
    normalized to ``send = 0`` — a message to yourself is the same
    mixing matrix with no wire.  Psum phases: contiguous blocks of
    ``group_size`` ranks, ``group_size | world``.

    Returns the normalized spec (new dict); raises ``ValueError`` with
    an ``is_unsupported_config``-matching message for malformed specs.
    """
    if not isinstance(spec, dict):
        raise ValueError("synthesized spec must be a dict "
                         "(unsupported spec type)")
    if spec.get("v") != SPEC_VERSION:
        raise ValueError(f"synthesized spec version {spec.get('v')!r} "
                         f"unsupported (expected {SPEC_VERSION})")
    n = int(spec.get("world", 0))
    if n < 2:
        raise ValueError(f"synthesized spec world={n} unsupported: "
                         "need >= 2 gossip ranks")
    if world_size is not None and int(world_size) != n:
        raise ValueError(
            f"synthesized spec was searched for world={n}; "
            f"world_size={world_size} unsupported (re-synthesize for "
            "the new world instead of reusing the stamp)")
    phases = spec.get("phases")
    if not phases:
        raise ValueError("synthesized spec has no phases (unsupported)")
    ident = np.arange(n)
    out_phases = []
    for i, ph in enumerate(phases):
        kind = ph.get("kind")
        if kind == "edge":
            perm = np.asarray(ph.get("perm", ()), dtype=np.int64)
            send = np.asarray(ph.get("send", ()), dtype=np.float64)
            if perm.shape != (n,) or not np.array_equal(np.sort(perm),
                                                        ident):
                raise ValueError(
                    f"synthesized spec phase {i}: perm is not a "
                    f"permutation of range({n}) (unsupported)")
            if send.shape != (n,) or (send < 0).any() or (send > 1).any():
                raise ValueError(
                    f"synthesized spec phase {i}: send weights must be "
                    f"{n} floats in [0, 1] (unsupported)")
            send = np.where(perm == ident, 0.0, send)
            if not (send > 0).any():
                raise ValueError(
                    f"synthesized spec phase {i}: edge phase sends "
                    "nothing (unsupported)")
            out_phases.append({"kind": "edge",
                               "perm": [int(v) for v in perm],
                               "send": [float(v) for v in send]})
        elif kind == "psum":
            g = int(ph.get("group_size", 0))
            if g < 2 or n % g:
                raise ValueError(
                    f"synthesized spec phase {i}: psum group_size={g} "
                    f"unsupported (need 2 <= g and g | world={n})")
            out_phases.append({"kind": "psum", "group_size": g})
        else:
            raise ValueError(f"synthesized spec phase {i}: kind "
                             f"{kind!r} unsupported (edge | psum)")
    return {"v": SPEC_VERSION, "world": n, "phases": out_phases}


def spec_fingerprint(spec: dict) -> str:
    """Stable content hash of a normalized spec (artifact provenance)."""
    payload = json.dumps(validate_spec(spec), sort_keys=True,
                         separators=(",", ":"))
    return hashlib.sha1(payload.encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class SynthesizedSchedule(GossipSchedule):
    """A :class:`GossipSchedule` whose phases are a searched composition.

    The inherited table fields hold the effective schedule (edge phases
    in sub-round 0, psum phases as ``g − 1`` rotate-permutations, padded
    to a uniform width with zero-weight identity sub-rounds), so the
    verifier, spectral-gap machinery, and numpy simulator treat it like
    any flat schedule.  The extra fields tell the round and the
    cost models which phases collapse into one grouped collective.
    """

    # one entry per table phase: "edge" | "psum"
    phase_kinds: tuple = ()
    # per phase: tuple of rank-tuples for psum phases, None for edge
    phase_groups: tuple = ()
    rounds_per_cycle: int = 0    # == num_phases (one round each)
    spec: dict | None = None     # normalized round-trip spec

    def edge_phase_schedule(self, phase: int) -> GossipSchedule:
        """Compact one-phase tables for edge phase ``phase`` (no psum
        padding rows): what the edge round actually executes."""
        if self.phase_kinds[phase] != "edge":
            raise ValueError(f"phase {phase} is not an edge phase")
        return GossipSchedule(
            perms=np.ascontiguousarray(self.perms[phase:phase + 1, :1]),
            self_weight=np.ascontiguousarray(
                self.self_weight[phase:phase + 1]),
            edge_weights=np.ascontiguousarray(
                self.edge_weights[phase:phase + 1, :1]),
            regular=False, world_size=self.world_size, peers_per_itr=1,
            num_phases=1)


class SynthesizedGraph(GraphTopology):
    """Topology adapter around a synthesized-schedule spec.

    Registered as ``"synth"`` in ``TOPOLOGY_NAMES`` so plans round-trip
    by name, but — unlike phone-book topologies — it cannot be built
    from ``(world, peers_per_itr)`` alone: without a ``spec`` the
    constructor refuses with an unsupported-configuration error, which
    is what makes the planner's registry scan skip it.  Specs come from
    the synthesizer's search (``--topology synth``) or from a stamped
    plan (checkpoint meta / supervisor replan).
    """

    # delegates and members are not interchangeable partners
    supports_pairing = False

    def __init__(self, world_size: int, peers_per_itr: int = 1,
                 spec: dict | None = None):
        if spec is None:
            raise ValueError(
                "synthesized topology is unsupported without a schedule "
                "spec: run the synthesizer (--topology synth, or "
                "scripts/plan.py --synthesize) or pass a stamped plan's "
                "spec")
        self.spec = validate_spec(spec, world_size)
        self.world_size = int(world_size)
        # accepted for run-layer signature compatibility; the schedule's
        # actual fan-out is baked into the spec
        self.peers_per_itr = int(peers_per_itr)
        # tables are pure functions of the spec — compile once, reuse
        # for every consumer (schedule hook, phone book, out_peers)
        self._schedule = self._compile()
        # informational phone book (debugging / repr): per-rank out-peers
        # over the whole cycle
        book: list[list[int]] = [[] for _ in range(self.world_size)]
        sched = self._schedule
        for p in range(sched.num_phases):
            for i in range(sched.peers_per_itr):
                for src in range(self.world_size):
                    dst = int(sched.perms[p, i, src])
                    if sched.edge_weights[p, i, src] > 0 \
                            and dst != src and dst not in book[src]:
                        book[src].append(dst)
        self.phone_book = book
        self._book_len = max(len(b) for b in book)

    # -- topology properties ----------------------------------------------

    def is_regular_graph(self) -> bool:
        return False   # searched weights are not doubly stochastic

    def is_bipartite_graph(self) -> bool:
        return False

    def is_dynamic_graph(self) -> bool:
        return True

    @property
    def num_phases(self) -> int:
        return len(self.spec["phases"])

    # -- schedule compilation ---------------------------------------------

    def _compile(self) -> SynthesizedSchedule:
        n = self.world_size
        phases = self.spec["phases"]
        width = max([1] + [ph["group_size"] - 1 for ph in phases
                           if ph["kind"] == "psum"])
        P = len(phases)
        ident = np.arange(n, dtype=np.int32)
        perms = np.tile(ident, (P, width, 1))
        self_w = np.ones((P, n), dtype=np.float64)
        edge_w = np.zeros((P, width, n), dtype=np.float64)
        kinds: list[str] = []
        groups: list[tuple | None] = []
        base_all = np.arange(n)
        for p, ph in enumerate(phases):
            if ph["kind"] == "edge":
                perms[p, 0] = np.asarray(ph["perm"], dtype=np.int32)
                send = np.asarray(ph["send"], dtype=np.float64)
                edge_w[p, 0] = send
                self_w[p] = 1.0 - send
                kinds.append("edge")
                groups.append(None)
            else:
                g = ph["group_size"]
                base = (base_all // g) * g
                offset = base_all - base
                self_w[p, :] = 1.0 / g
                for d in range(1, g):
                    perms[p, d - 1] = base + (offset + d) % g
                    edge_w[p, d - 1] = 1.0 / g
                kinds.append("psum")
                groups.append(tuple(tuple(range(j * g, (j + 1) * g))
                                    for j in range(n // g)))
        totals = self_w + edge_w.sum(axis=1)
        if np.abs(totals - 1.0).max() > 1e-12:
            raise ValueError(
                f"synthesized mixing weights have column sums deviating "
                f"by {np.abs(totals - 1.0).max():.2e} from 1 "
                "(column-stochasticity violated)")
        return SynthesizedSchedule(
            perms=perms, self_weight=self_w, edge_weights=edge_w,
            regular=False, world_size=n, peers_per_itr=width,
            num_phases=P, phase_kinds=tuple(kinds),
            phase_groups=tuple(groups), rounds_per_cycle=P,
            spec=self.spec)

    def compile_schedule(self, mixing: MixingStrategy | None = None
                         ) -> SynthesizedSchedule:
        """The :func:`~.schedule.build_schedule` hook.  Mixing weights are
        baked into the searched spec, so only uniform (or no) mixing is
        accepted — a forced alpha would silently diverge from the tables
        the search verified and priced."""
        if mixing is not None and not mixing.is_uniform():
            raise ValueError(
                "synthesized schedules carry their searched per-rank "
                "weights; self-weighted mixing is unsupported (the "
                "spec already fixes every weight)")
        return self._schedule

    # -- schedule extraction (informational API) ---------------------------

    @property
    def all_phase_permutations(self) -> np.ndarray:
        return self._schedule.perms

    def phase_permutation(self, phase: int) -> np.ndarray:
        return self.all_phase_permutations[phase % self.num_phases]

    def out_peers(self, rank: int, phase: int) -> tuple[int, ...]:
        sched = self._schedule
        p = phase % sched.num_phases
        return tuple(int(sched.perms[p, i, rank])
                     for i in range(sched.peers_per_itr)
                     if sched.edge_weights[p, i, rank] > 0.0
                     and int(sched.perms[p, i, rank]) != rank)

    def __repr__(self) -> str:
        kinds = [ph["kind"] for ph in self.spec["phases"]]
        return (f"{type(self).__name__}(world_size={self.world_size}, "
                f"phases={'+'.join(kinds)})")
