"""Plan objects and the launch-time topology policy engine.

Turns the scorer's passive ranking into decisions:

* ``plan_for`` — pick the best (topology, mixing) for a world size,
  auto-switching away from anything whose rotation-cycle spectral gap
  falls below the floor (default 0.01 — the ring-at-pod-scale failure);
* alpha co-optimization — when self-weighted mixing is requested, the
  plan carries a searched alpha instead of the free-knob default 0.5
  (see :mod:`.alpha`);
* **periodic global averaging** — when no pure-gossip candidate clears
  the floor (e.g. constraints force a ring), the plan emits an every-k
  exact-allreduce schedule in the spirit of *Accelerating Gossip SGD
  with Periodic Global Averaging* (Chen et al.): gossip keeps running,
  and an exact average every ``k`` steps restores the consensus the
  graph cannot provide.  ``k`` is the number of steps the chosen graph
  needs for one e-fold of consensus contraction, capped at ``1/floor``
  (the horizon a floor-clearing graph would need) so a fully
  disconnected configuration still averages every ``1/floor`` steps;
* ``check_topology`` — score a *user-forced* topology and attach a loud
  structured warning (measured gap, floor, suggested alternative) when
  it is below the floor, instead of silently training on a non-mixing
  graph.

``resolve_topology`` is the single entry point the run layer calls: it
dispatches between auto and forced modes, applies user overrides, logs
the chosen plan as one JSON line (the "stamp" that also lands in
checkpoint metadata), and emits the warnings.

A copy of ``stochastic_gradient_push_tpu/planner/policy.py``; plans and
their ``to_dict()`` are the reference's.  The reference can publish the
plan as a telemetry event; the port logs the line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math

from ..topology import TOPOLOGY_NAMES, topology_name
from ..topology.hierarchical import HierarchicalGraph
from ..topology.mixing import SelfWeightedMixing
from .alpha import alpha_gap, optimize_alpha
from .interconnect import InterconnectModel
from .scorer import (
    DEFAULT_GAP_FLOOR,
    DEFAULT_PEER_COUNTS,
    evaluate_candidate,
    instantiate_graph,
    score_candidates,
)

__all__ = ["Plan", "PlanConstraints", "plan_for", "check_topology",
           "resolve_topology", "DEFAULT_GAP_FLOOR"]

# alpha the reference (and this repo's SelfWeightedMixing) defaults to —
# the "free knob" value the co-optimizer replaces
DEFAULT_ALPHA = 0.5

_ALGORITHMS = ("sgp", "dpsgd")


@dataclasses.dataclass(frozen=True)
class PlanConstraints:
    """Knobs bounding the planner's search space."""

    floor: float = DEFAULT_GAP_FLOOR
    # restrict the search to these topology names (None = all registered)
    allowed: tuple[str, ...] | None = None
    # peers_per_itr values to consider (None = scorer defaults)
    peer_counts: tuple[int, ...] | None = None
    # False = uniform mixing; True = co-optimize a scalar alpha; a float
    # forces that alpha (the plan then reports what co-optimization would
    # have recovered)
    self_weighted: bool | float = False
    # allow the every-k exact-averaging fallback when nothing clears the
    # floor (False = plan the best candidate anyway and warn)
    allow_global_avg: bool = True
    # fabric cost model pricing every candidate edge (torus ICI hops
    # inside a slice, flat DCN weight across; None = uniform 1-D torus).
    # A model with slice structure also fixes the hierarchical
    # candidate's slice decomposition to the fabric's.
    interconnect: InterconnectModel | None = None
    # the run requests overlap mode / fault injection.  Fault injection
    # is a flat-schedule feature (the hierarchical grouped psum has no
    # per-edge mask), so hierarchical candidates must not win a faulted
    # run's ranking.  Overlap composes with EVERY candidate — the
    # hierarchical round defers its delegate (DCN) share and keeps the
    # ICI-local psum at consume time — so it no longer constrains the
    # search at all; the field is accepted for API stability only (the
    # run's overlap mode is not part of the plan stamp).
    overlap: bool = False
    faults: bool = False
    # wire codec config ({"dtype", "block", "error_feedback"},
    # parallel/wire.py): gossip payload lanes are priced at the encoded
    # fraction (hierarchical intra-slice exact averages stay full
    # precision), and the config is stamped into the plan
    wire: dict | None = None
    # schedule synthesis request (planner/synthesize.py): a knob dict
    # ({"seed", "budget", "beam_width", "max_phases", and optionally a
    # stamped "spec" to reuse}).  Non-None routes plan_for through the
    # synthesizer, which falls back to the registry plan whenever the
    # search does not strictly beat it — the recovery policy threads a
    # synthesized run's stamp here.
    synth: dict | None = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch-time gossip plan: what to run and why.

    ``to_dict()`` is JSON-safe and is what the run layer logs and stamps
    into checkpoint metadata for reproducibility.
    """

    world: int
    ppi: int
    topology: str            # name from topology.TOPOLOGY_NAMES
    mixing: str              # "uniform" or "self-weighted(<alpha>)"
    alpha: float | None      # scalar SelfWeightedMixing alpha, if any
    gap: float               # measured rotation-cycle spectral gap
    floor: float
    num_phases: int
    comm_cost: float         # payloads per rank per consensus e-fold
    global_avg_every: int    # exact allreduce every k steps (0 = off)
    algorithm: str           # "sgp" | "dpsgd"
    auto: bool               # True = planner chose; False = user-forced
    rationale: str
    warnings: tuple[str, ...] = ()
    ranking: tuple[dict, ...] = ()  # top scored candidates, best first
    slice_size: int | None = None   # hierarchical slice decomposition
    interconnect: dict | None = None  # fabric model the plan was priced on
    # wire codec the run will gossip through ({"dtype", "block",
    # "error_feedback"}; None = exact f32) — comm_cost above is priced at
    # this encoding, and the stamp rides into checkpoint metadata
    wire: dict | None = None
    # synthesized-schedule stamp (topology == "synth"): the search knobs
    # plus the winning spec, JSON-safe — checkpoint meta carries it, so
    # resume/replan rebuild the exact searched schedule
    synth: dict | None = None

    @property
    def graph_class(self):
        cls = TOPOLOGY_NAMES[self.topology]
        if self.synth is not None and self.synth.get("spec"):
            from ..topology.synthesized import SynthesizedGraph

            # bind the stamped spec so graph_class(world, peers_per_itr=
            # ppi) rebuilds exactly the searched, verified, priced tables
            return functools.partial(SynthesizedGraph,
                                     spec=self.synth["spec"])
        if self.slice_size and isinstance(cls, type) \
                and issubclass(cls, HierarchicalGraph):
            # the run layer instantiates graph_class(world, peers_per_itr=
            # ppi); bind the planned slice decomposition so the compiled
            # schedule matches the one that was scored and stamped
            return functools.partial(cls, slice_size=self.slice_size)
        return cls

    def mixing_strategy(self):
        """Instantiate the plan's mixing strategy (None = uniform, the
        algorithm layer's default)."""
        return None if self.alpha is None else SelfWeightedMixing(self.alpha)

    def below_floor(self) -> bool:
        return self.gap < self.floor

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["gap"] = round(self.gap, 6)
        d["comm_cost"] = (round(self.comm_cost, 3)
                          if math.isfinite(self.comm_cost) else None)
        d["warnings"] = list(self.warnings)
        d["ranking"] = list(self.ranking)
        return d

    def summary(self) -> str:
        parts = [f"topology={self.topology}", f"ppi={self.ppi}",
                 f"mixing={self.mixing}", f"gap={self.gap:.4f}",
                 f"floor={self.floor}"]
        if self.global_avg_every:
            parts.append(f"global_avg_every={self.global_avg_every}")
        return " ".join(parts)


def _wire_fraction(wire_cfg: dict | None) -> float:
    """Encoded-bytes ratio of the configured wire codec (1.0 = exact)."""
    if not wire_cfg or wire_cfg.get("dtype") in (None, "f32"):
        return 1.0
    from ..parallel.wire import DEFAULT_WIRE_BLOCK, get_codec

    return get_codec(wire_cfg["dtype"],
                     wire_cfg.get("block") or DEFAULT_WIRE_BLOCK
                     ).wire_fraction()


def averaging_period(gap: float, floor: float) -> int:
    """Exact-averaging period for a below-floor graph: the steps the graph
    needs per consensus e-fold, capped at the floor-equivalent horizon."""
    cap = max(1, int(math.ceil(1.0 / floor)))
    if gap <= 0.0:
        return cap
    return max(1, min(cap, int(math.ceil(1.0 / gap))))


def _check_algorithm(algorithm: str, self_weighted) -> None:
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"planner supports algorithms {_ALGORITHMS}; "
                         f"got {algorithm!r} (all_reduce is already exact "
                         "and adpsgd mixes via pairing schedules)")
    if algorithm == "dpsgd" and self_weighted:
        raise ValueError("dpsgd requires a regular (doubly-stochastic) "
                         "schedule; self-weighted mixing is a push-sum "
                         "capability")


def _apply_self_weighted(cand, graph, self_weighted):
    """Resolve the requested self-weighted mixing against ``graph``.

    Returns (mixing name, alpha, gap, rationale fragment, warnings).
    """
    tuned_alpha, tuned_gap = optimize_alpha(graph)
    if self_weighted is True:
        frag = (f"alpha co-optimized to {tuned_alpha:.4f} "
                f"(gap {tuned_gap:.4f}; default alpha "
                f"{DEFAULT_ALPHA} would give "
                f"{alpha_gap(graph, DEFAULT_ALPHA):.4f})")
        return (f"self-weighted({tuned_alpha:.4f})", tuned_alpha,
                tuned_gap, frag, ())
    forced = float(self_weighted)
    forced_gap = alpha_gap(graph, forced)
    warnings = ()
    if forced_gap < 0.9 * tuned_gap:
        warnings = ((
            "alpha-suboptimal: " + json.dumps({
                "topology": cand.topology, "world": cand.world,
                "ppi": cand.ppi, "alpha": forced,
                "gap": round(forced_gap, 6),
                "suggested_alpha": round(tuned_alpha, 4),
                "suggested_gap": round(tuned_gap, 6)},
                sort_keys=True)),)
    frag = (f"alpha forced to {forced} (gap {forced_gap:.4f}; "
            f"co-optimization would give {tuned_gap:.4f} at "
            f"alpha {tuned_alpha:.4f})")
    return (f"self-weighted({forced:.4f})", forced, forced_gap, frag,
            warnings)


def plan_for(world: int, ppi: int | None = None, algorithm: str = "sgp",
             constraints: PlanConstraints | None = None,
             global_avg_every: int | None = None) -> Plan:
    """Choose the best gossip plan for ``world`` ranks.

    Args:
      world: gossip world size (ranks along the gossip axis).
      ppi: fix peers_per_itr to this value (the user's communication
        budget); None = search the default grid.
      algorithm: "sgp" (push-sum) or "dpsgd" (doubly-stochastic).
      constraints: search-space bounds; see :class:`PlanConstraints`.
      global_avg_every: user override for the exact-averaging period —
        None defers to policy, 0 disables it even below the floor
        (warned), k forces every-k averaging.
    """
    cons = constraints or PlanConstraints()
    _check_algorithm(algorithm, cons.self_weighted)
    if cons.synth is not None and world >= 2:
        from .synthesize import SynthesisConfig, plan_synthesized

        return plan_synthesized(
            world, ppi=ppi, algorithm=algorithm, floor=cons.floor,
            interconnect=cons.interconnect, wire=cons.wire,
            global_avg_every=global_avg_every, overlap=cons.overlap,
            faults=cons.faults, self_weighted=cons.self_weighted,
            config=SynthesisConfig.from_dict(cons.synth),
            stamped_spec=cons.synth.get("spec"))
    if world < 2:
        return Plan(world=world, ppi=ppi or 1,
                    topology="npeer-exponential", mixing="uniform",
                    alpha=None, gap=1.0, floor=cons.floor, num_phases=1,
                    comm_cost=0.0, global_avg_every=0, algorithm=algorithm,
                    auto=True, rationale="world < 2: gossip is a no-op")
    peer_counts = ((int(ppi),) if ppi else
                   cons.peer_counts or DEFAULT_PEER_COUNTS)
    cands = score_candidates(world, peer_counts, floor=cons.floor,
                             allowed=cons.allowed,
                             interconnect=cons.interconnect,
                             wire_fraction=_wire_fraction(cons.wire))
    if algorithm == "dpsgd":
        # D-PSGD mixes doubly-stochastically; an irregular schedule (the
        # hierarchical two-level graph) would be rejected by the
        # algorithm at launch, so it must not win the ranking
        cands = [c for c in cands if c.regular]
    if cons.faults:
        # PushSumGossip rejects hierarchical schedules under fault
        # injection (the grouped psum has no per-edge mask), so the
        # planner must not recommend one to such a run.  Overlap no
        # longer constrains the ranking: the hierarchical round defers
        # its delegate share like any flat edge (overlap_launch +
        # intra_average at consume).
        cands = [c for c in cands if not c.slice_size]
    if not cands:
        raise ValueError(
            f"no registered topology supports world={world} with "
            f"peers_per_itr in {peer_counts}"
            + (f" within allowed={sorted(cons.allowed)}" if cons.allowed
               else "")
            + (" for algorithm=dpsgd (regular schedules only)"
               if algorithm == "dpsgd" else "")
            + (" compatible with fault injection (flat schedules only)"
               if cons.faults else ""))
    best = cands[0]
    warnings: list[str] = []

    gap, mixing, alpha = best.gap, "uniform", None
    rationale = (f"{best.topology} (ppi {best.ppi}) ranked best of "
                 f"{len(cands)} candidates: gap {best.gap:.4f}, "
                 f"{best.num_phases} phase(s)/cycle")
    if best.slice_size:
        rationale += (f", {world // best.slice_size} slices of "
                      f"{best.slice_size}")
    if math.isfinite(best.comm_cost):
        rationale += (f", ~{best.comm_cost:.1f} payloads/rank per "
                      "consensus e-fold")
    else:
        rationale += " (cycle does not contract)"
    if cons.interconnect is not None and math.isfinite(best.priced_cost):
        rationale += (f" (priced {best.priced_cost:.1f} on the fabric "
                      f"model: ICI {best.ici_per_efold:.1f} + DCN "
                      f"{best.dcn_per_efold:.1f})")
    wf = _wire_fraction(cons.wire)
    if wf != 1.0:
        rationale += (f"; gossip lanes priced at the "
                      f"{cons.wire['dtype']} wire ({wf:.3f} of f32)")
    if cons.self_weighted:
        # Candidate.graph_class binds the scored slice decomposition
        graph = best.graph_class(world, peers_per_itr=best.ppi)
        mixing, alpha, gap, frag, sw_warn = _apply_self_weighted(
            best, graph, cons.self_weighted)
        rationale += "; " + frag
        warnings.extend(sw_warn)

    gae = 0
    if gap < cons.floor:
        if global_avg_every is not None:
            gae = max(0, global_avg_every)
        elif cons.allow_global_avg:
            gae = averaging_period(gap, cons.floor)
        if gae:
            rationale += (
                f"; no candidate clears the gap floor {cons.floor} — "
                f"interleaving an exact global average every "
                f"{gae} step(s) (periodic global averaging, "
                "Chen et al.) to restore consensus")
        else:
            warnings.append(
                "below-floor-plan: " + json.dumps({
                    "topology": best.topology, "world": world,
                    "ppi": best.ppi, "gap": round(gap, 6),
                    "floor": cons.floor,
                    "hint": "periodic global averaging is disabled; "
                            "expect slow consensus — enable it or relax "
                            "the topology constraints"}, sort_keys=True))
    elif global_avg_every:
        gae = global_avg_every
        rationale += (f"; exact global average every {gae} step(s) by "
                      "user request")

    return Plan(world=world, ppi=best.ppi, topology=best.topology,
                mixing=mixing, alpha=alpha, gap=gap, floor=cons.floor,
                num_phases=best.num_phases, comm_cost=best.comm_cost,
                global_avg_every=gae, algorithm=algorithm,
                auto=True, rationale=rationale, warnings=tuple(warnings),
                ranking=tuple(c.to_dict() for c in cands[:8]),
                slice_size=best.slice_size,
                interconnect=(cons.interconnect.to_dict()
                              if cons.interconnect else None),
                wire=cons.wire)


def check_topology(world: int, graph_class, ppi: int = 1,
                   algorithm: str = "sgp",
                   floor: float = DEFAULT_GAP_FLOOR,
                   self_weighted: bool | float = False,
                   global_avg_every: int | None = None,
                   interconnect: InterconnectModel | None = None,
                   overlap: bool = False, faults: bool = False,
                   wire: dict | None = None) -> Plan:
    """Score a user-forced topology and warn if it is below the floor.

    The warning is structured (one JSON payload) and names the measured
    gap plus the planner's suggested alternative, so a below-floor launch
    is a deliberate, documented decision rather than a silent one.
    ``global_avg_every`` follows :func:`plan_for`'s override semantics
    (None = policy decides, 0 = explicitly off, k = forced period).
    """
    _check_algorithm(algorithm, self_weighted)
    name = topology_name(graph_class)
    if world < 2:
        return Plan(world=world, ppi=ppi, topology=name, mixing="uniform",
                    alpha=None, gap=1.0, floor=floor, num_phases=1,
                    comm_cost=0.0, global_avg_every=0, algorithm=algorithm,
                    auto=False, rationale="world < 2: gossip is a no-op")
    cand = evaluate_candidate(graph_class, world, ppi,
                              interconnect=interconnect,
                              wire_fraction=_wire_fraction(wire))
    if cand is None:
        raise ValueError(f"{name} does not support world={world} with "
                         f"peers_per_itr={ppi}")
    if algorithm == "dpsgd" and not cand.regular:
        raise ValueError(
            f"dpsgd requires a regular (doubly-stochastic) schedule; "
            f"{name} is irregular — use push-sum (sgp) or a flat topology")
    if cand.slice_size and faults:
        raise ValueError(
            f"{name} is a two-level hierarchical schedule; fault "
            "injection is a flat-schedule feature (the grouped psum has "
            "no per-edge mask) — use a flat topology for fault drills")
    gap, mixing, alpha = cand.gap, "uniform", None
    rationale = f"user-forced {name} (ppi {ppi}): gap {gap:.4f}"
    if cand.slice_size:
        rationale += (f", {world // cand.slice_size} slices of "
                      f"{cand.slice_size}")
    warnings: list[str] = []
    if self_weighted:
        graph = instantiate_graph(graph_class, world, ppi, interconnect)
        mixing, alpha, gap, frag, sw_warn = _apply_self_weighted(
            cand, graph, self_weighted)
        rationale += "; " + frag
        warnings.extend(sw_warn)

    gae = 0
    if gap < floor:
        alt = plan_for(world, ppi=ppi, algorithm=algorithm,
                       constraints=PlanConstraints(
                           floor=floor, interconnect=interconnect,
                           overlap=overlap, faults=faults, wire=wire))
        gae = (averaging_period(gap, floor) if global_avg_every is None
               else max(0, global_avg_every))
        payload = {
            "topology": name, "world": world, "ppi": ppi,
            "gap": round(gap, 6), "floor": floor,
            "suggested_topology": alt.topology,
            "suggested_gap": round(alt.gap, 6),
            "global_avg_every": gae,
        }
        recovery = (f"running with an exact global average every {gae} "
                    "step(s)" if gae else
                    "periodic global averaging explicitly disabled — "
                    "expect slow consensus")
        warnings.append(
            "topology-below-floor: " + json.dumps(payload, sort_keys=True)
            + f" — SGP's rate degrades as 1/gap; use --topology "
              f"{alt.topology} (gap {alt.gap:.4f}); {recovery}")
        rationale += f"; below floor {floor} — {recovery}"
    elif global_avg_every:
        gae = global_avg_every
        rationale += (f"; exact global average every {gae} step(s) by "
                      "user request")

    return Plan(world=world, ppi=ppi, topology=name, mixing=mixing,
                alpha=alpha, gap=gap, floor=floor,
                num_phases=cand.num_phases, comm_cost=cand.comm_cost,
                global_avg_every=gae, algorithm=algorithm,
                auto=False, rationale=rationale, warnings=tuple(warnings),
                slice_size=cand.slice_size,
                interconnect=(interconnect.to_dict()
                              if interconnect else None),
                wire=wire)


def resolve_topology(world: int, *, ppi: int = 1,
                     topology: str | None = None,
                     graph_class=None,
                     floor: float = DEFAULT_GAP_FLOOR,
                     algorithm: str = "sgp",
                     self_weighted: bool | float = False,
                     global_avg_every: int | None = None,
                     interconnect: InterconnectModel | None = None,
                     overlap: bool = False, faults: bool = False,
                     wire: dict | None = None,
                     synth: dict | None = None,
                     log=None, registry=None) -> Plan:
    """Run-layer entry point: resolve ``--topology``/``--graph_type`` into
    a :class:`Plan`, log it, and emit any warnings.

    Args:
      topology: "auto" (plan), "synth" (search a schedule against the
        priced fabric, falling back to the registry when not beaten), a
        registered name (forced), or None (forced via ``graph_class``).
      graph_class: the topology class selected by legacy flags; used when
        ``topology`` is None.
      global_avg_every: user override for the averaging period (None =
        the policy decides; 0 = explicitly off, warned below the floor;
        k = every-k averaging regardless of the gap).
      interconnect: fabric cost model from the CLI's --slice_size /
        --dcn_cost / --ici_cost flags (None = uniform fabric); candidate
        pricing and the hierarchical slice decomposition follow it.
      overlap / faults: the run requests overlap mode / fault injection.
        Hierarchical schedules reject fault injection at launch, so a
        faulted run's auto ranking excludes them and forced mode fails
        fast; overlap composes with every candidate (the hierarchical
        delegate share defers like any flat edge) and only rides into
        the plan stamp.
      wire: the run's wire codec config from --wire_dtype/--wire_block/
        --error_feedback ({"dtype", "block", "error_feedback"}); gossip
        lanes are priced at the encoded fraction and the config is
        stamped into the plan (and from there into checkpoint meta).
      synth: search-budget knobs for --topology synth (the --synth_*
        flags; {"seed", "budget", "beam_width", "max_phases"}, plus an
        optional stamped "spec" to reuse).  Only meaningful with
        topology == "synth".
      log: optional logger; the plan is logged as one JSON line
        (``gossip plan: {...}``, sorted keys) and each warning loudly via
        ``log.warning``.
      registry: optional telemetry registry; when set, the plan publishes
        as a typed ``plan`` event (the registry's compatibility sink
        renders the same ``gossip plan:`` line) instead of the direct
        line.
    """
    if topology == "synth":
        from .synthesize import SynthesisConfig, plan_synthesized

        synth = synth or {}
        plan = plan_synthesized(
            world, ppi=ppi, algorithm=algorithm, floor=floor,
            interconnect=interconnect, wire=wire,
            global_avg_every=global_avg_every, overlap=overlap,
            faults=faults, self_weighted=self_weighted,
            config=SynthesisConfig.from_dict(synth),
            stamped_spec=synth.get("spec"))
    elif topology == "auto":
        plan = plan_for(world, ppi=ppi, algorithm=algorithm,
                        constraints=PlanConstraints(
                            floor=floor, self_weighted=self_weighted,
                            interconnect=interconnect,
                            overlap=overlap, faults=faults, wire=wire),
                        global_avg_every=global_avg_every)
    else:
        cls = TOPOLOGY_NAMES[topology] if topology else graph_class
        if cls is None:
            raise ValueError("resolve_topology needs a topology name or a "
                             "graph_class")
        plan = check_topology(world, cls, ppi=ppi, algorithm=algorithm,
                              floor=floor, self_weighted=self_weighted,
                              global_avg_every=global_avg_every,
                              interconnect=interconnect,
                              overlap=overlap, faults=faults, wire=wire)
    if registry is not None:
        # info like the direct line (plan *warnings* go via log below)
        registry.emit("plan", plan.to_dict(), severity="info")
    elif log is not None:
        log.info("gossip plan: %s", json.dumps(plan.to_dict(),
                                               sort_keys=True))
    if log is not None:
        for msg in plan.warnings:
            log.warning(msg)
    return plan
