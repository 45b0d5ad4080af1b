"""Schedule synthesizer: search hybrid psum/ppermute cycles on the priced fabric.

The rest of the planner *ranks* a phone book; this module *composes*
schedules.  SGP's rate bound degrades as ``1/gap`` of the rotation-cycle
mixing matrix (PAPER.md) and the fabric prices every edge
(:class:`~.interconnect.InterconnectModel`), so the natural objective is
the one the scorer already ranks registry candidates by: **priced cost
per consensus e-fold**, ``cycle_cost / −ln(1 − gap)``.  Following "A
Generalization of the Allreduce Operation" (PAPERS.md), the search space
is compositions of the two primitives the collective layer compiles and
the verifier checks:

* **edge phases** — one ``ppermute`` (permutation + per-rank send
  weight): global rotations, slice-local rotations, hierarchical-style
  sparse *delegate exchanges* (a few ranks per slice cross DCN, the rest
  fix at zero weight — crucially with a *different* slice offset per
  rail, which the registry's hierarchical graph cannot express), and
  seeded random derangements;
* **psum phases** — one grouped exact average over equal contiguous
  blocks (``g | slice_size``, so the collective stays ICI-local on the
  declared fabric).  On a fabric with no slice structure psum moves are
  not generated at all: there is no ICI domain that guarantees the
  grouped collective is local, and under ring-allreduce pricing a
  whole-world psum would degenerately dominate every gossip schedule.

**Why beam search, not annealing.**  The search must be reproducible
run-to-run (a resumed run must re-derive the stamped schedule): a
beam over a deterministically
ordered move library with lexicographic tie-breaks is exactly
reproducible on any platform, while annealing's stochastic acceptance
makes the trajectory sensitive to float rounding in the accept
comparison.  Beam also fits the structure: the objective is evaluated on
whole cycles, cheap to score incrementally (the spectral-gap fingerprint
cache absorbs re-evaluations), and good cycles are extensions of good
prefixes.  The one wrinkle is that the best prefixes are often *not yet
contracting* — a delegate phase or a psum phase alone has spectral gap
zero (non-delegates receive nothing / slices never talk), yet is one
move away from the best known schedules — so the beam reserves
``stall_width`` slots for zero-gap prefixes ranked by cycle cost.
Seeding (``SynthesisConfig.seed``) feeds only the random-derangement
moves; everything else is closed-form, so two runs with equal config are
bit-identical.

Every candidate is validated through the public hooks the registry uses:
``analysis.verify_schedule`` (SGPV bijection/column-stochasticity/
contraction — cheap because the spectral-gap fingerprint cache memoizes
the eigensolve), priced by ``scorer.cycle_cost``, and the winner is
re-scored through ``scorer.evaluate_candidate`` so its ranking row is
built by the same code path as every registry row.

:func:`plan_synthesized` wraps the search in plan policy: the winner
must strictly beat the cheapest floor-clearing registry candidate on
priced cost per e-fold, else the registry plan is returned unchanged
(with the attempt noted in the rationale) — synthesis can only ever
improve a launch, never regress one.

A copy of ``stochastic_gradient_push_tpu/planner/synthesize.py``: the
same move library, order, tie-breaks and seeded draws, so equal knobs
give the reference's winner and fingerprint.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from ..analysis import verify_schedule
from ..topology import build_schedule
from ..topology.synthesized import (
    SPEC_VERSION,
    SynthesizedGraph,
    spec_fingerprint,
    validate_spec,
)
from .interconnect import UNIFORM, InterconnectModel
from .scorer import (
    DEFAULT_GAP_FLOOR,
    DEFAULT_PEER_COUNTS,
    consensus_cost,
    cycle_cost,
    evaluate_candidate,
    score_candidates,
)

__all__ = ["SynthesisConfig", "SynthesisResult", "synthesize",
           "plan_synthesized"]


@dataclasses.dataclass(frozen=True)
class SynthesisConfig:
    """Search-budget knobs (the ``--synth_*`` CLI flags)."""

    seed: int = 0           # feeds the random-derangement moves only
    beam_width: int = 6     # contracting prefixes kept per depth
    stall_width: int = 4    # zero-gap prefixes kept per depth (see above)
    max_phases: int = 6     # longest cycle considered
    budget: int = 1200      # max candidate-schedule evaluations
    send_weights: tuple = (0.5, 0.75, 0.9)  # edge-phase send-mass grid
    random_moves: int = 4   # seeded derangement moves in the library

    def to_dict(self) -> dict:
        return {"seed": self.seed, "beam_width": self.beam_width,
                "stall_width": self.stall_width,
                "max_phases": self.max_phases, "budget": self.budget}

    @classmethod
    def from_dict(cls, d: dict | None) -> "SynthesisConfig":
        """Build from a knob dict (plan stamps / CLI), ignoring unknown
        keys like the stamped ``spec``/``evals``."""
        d = d or {}
        kwargs = {}
        for f in ("seed", "beam_width", "stall_width", "max_phases",
                  "budget"):
            if d.get(f) is not None:
                kwargs[f] = int(d[f])
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class _Eval:
    """One scored candidate cycle."""

    gap: float
    cycle_ici: float        # per-rank priced cost of one full cycle
    cycle_dcn: float
    priced: float           # priced cost per consensus e-fold
    ici_per_efold: float
    dcn_per_efold: float


@dataclasses.dataclass(frozen=True)
class _State:
    """One beam entry: a phase sequence plus its evaluation."""

    phases: tuple
    key: str                # deterministic identity (tie-break + debug)
    ev: _Eval


@dataclasses.dataclass(frozen=True)
class SynthesisResult:
    """The search winner, in planner units (per-rank, per e-fold)."""

    spec: dict
    gap: float
    priced_cost: float
    ici_per_efold: float
    dcn_per_efold: float
    num_phases: int
    evals: int
    key: str
    from_seed_spec: bool = False

    def to_dict(self) -> dict:
        return {"gap": round(self.gap, 6),
                "priced_cost": round(self.priced_cost, 3),
                "ici_per_efold": round(self.ici_per_efold, 3),
                "dcn_per_efold": round(self.dcn_per_efold, 3),
                "num_phases": self.num_phases, "evals": self.evals,
                "fingerprint": spec_fingerprint(self.spec),
                "from_seed_spec": self.from_seed_spec}


# -- move library ------------------------------------------------------------


def _edge_phase(perm: np.ndarray, send: np.ndarray) -> dict:
    ident = np.arange(perm.size)
    send = np.where(perm == ident, 0.0, send)
    return {"kind": "edge", "perm": [int(v) for v in perm],
            "send": [float(v) for v in send]}


def _fabric_slices(world: int, model: InterconnectModel) -> int | None:
    """The fabric's slice size when it tiles the world into >= 2 slices
    of >= 2 ranks (the precondition for delegate / psum moves)."""
    s = model.slice_size
    if s and 2 <= s <= world // 2 and world % s == 0:
        return s
    return None


def _move_library(world: int, model: InterconnectModel,
                  cfg: SynthesisConfig, rng) -> list[tuple[str, dict]]:
    """Deterministically ordered ``(key, phase)`` moves for ``world``.

    Keys are stable human-readable identities; the beam's tie-breaks
    sort on them, so the library order is part of the contract.
    """
    n = world
    moves: list[tuple[str, dict]] = []
    s = _fabric_slices(n, model)
    ident = np.arange(n)
    sends = tuple(cfg.send_weights)

    # global rotations at exponential distances (the flat-gossip family)
    dists = [d for d in (1, 2, 4, 8, 16, 32) if d < n]
    if n // 2 not in dists and n // 2 >= 1:
        dists.append(n // 2)
    for d in sorted(set(dists)):
        for w in sends:
            moves.append((f"rot{d}w{w}",
                          _edge_phase((ident + d) % n, np.full(n, w))))

    if s:
        m = n // s
        base = (ident // s) * s
        offset = ident - base
        # slice-local rotations (ICI-cheap smoothing without a psum)
        for d in (1, 2, 4):
            if d >= s:
                break
            for w in sends:
                moves.append((f"srot{d}w{w}",
                              _edge_phase(base + (offset + d) % s,
                                          np.full(n, w))))
        # delegate exchanges: rails = the first f ranks of each slice,
        # rail r sends its slice's share to slice j + delta_r.  "spread"
        # gives every rail a DIFFERENT offset (f distinct slice edges per
        # phase at the same DCN message count the registry pays for f
        # same-offset rails); "same" reproduces the registry's shape.
        # Send-weight grid includes the hierarchical uniform-mixing value
        # 1 - 1/s (a delegate holds its slice mean after a psum; keeping
        # more than 1/s of it only slows cross-slice diffusion).
        del_sends = tuple(sorted(set(sends) | {round(1.0 - 1.0 / s, 12)}))
        fanouts = [f for f in (1, 2, 4) if f <= s]
        for f in fanouts:
            for base_delta in (1, 2):
                if base_delta % m == 0:
                    continue
                for pattern in ("spread", "same"):
                    deltas = [(base_delta * (2 ** r if pattern == "spread"
                                             else 1)) % m
                              for r in range(f)]
                    if any(d == 0 for d in deltas):
                        continue
                    for w in del_sends:
                        perm = ident.copy()
                        send = np.zeros(n)
                        for j in range(m):
                            for r in range(f):
                                src = j * s + r
                                perm[src] = ((j + deltas[r]) % m) * s + r
                                send[src] = w
                        moves.append(
                            (f"del{f}{pattern}{base_delta}w{w}",
                             _edge_phase(perm, send)))
        # grouped exact averages, ICI-local by construction (g | s keeps
        # every contiguous block inside one slice)
        for g in sorted({g for g in (2, 4, 8, s) if g >= 2 and s % g == 0}):
            moves.append((f"psum{g}", {"kind": "psum", "group_size": g}))

    # seeded derangement-ish permutations: the only stochastic moves;
    # rng(seed) makes them — and therefore the whole search — a pure
    # function of the config.  A draw that fixes every rank (possible
    # at tiny worlds) would be an empty phase, so it is skipped — the
    # draw still happens, keeping the sequence aligned across worlds.
    for i in range(cfg.random_moves):
        perm = rng.permutation(n)
        if (perm == ident).all():
            continue
        for w in sends[:1]:
            moves.append((f"rand{i}w{w}",
                          _edge_phase(perm, np.full(n, w))))
    # several generators can emit the same table under different keys
    # (f=1 spread == same; full-fanout same-offset delegates == global
    # rotations): dedupe by content, first key wins, so the budget and
    # the beam slots never re-score a known table
    seen: set = set()
    deduped = []
    for key, phase in moves:
        content = (phase["kind"], phase.get("group_size"),
                   tuple(phase.get("perm", ())),
                   tuple(phase.get("send", ())))
        if content in seen:
            continue
        seen.add(content)
        deduped.append((key, phase))
    return deduped


# -- evaluation --------------------------------------------------------------


def _evaluate(world: int, phases: tuple, model: InterconnectModel,
              wire_fraction: float) -> _Eval | None:
    """Score one candidate cycle through the public hooks; None when the
    spec is refused or the schedule fails verification (the guard is
    the contract; library moves are constructed to pass)."""
    spec = {"v": SPEC_VERSION, "world": world, "phases": list(phases)}
    try:
        schedule = build_schedule(SynthesizedGraph(world, spec=spec))
    except ValueError:
        return None
    findings, gap = verify_schedule(schedule, "synthesized", "<synth>", 0)
    if any(f.rule != "SGPV103" for f in findings):
        return None
    # SGPV103 (zero spectral gap) is not a malformed table — it is a
    # not-yet-contracting prefix (a lone delegate or psum phase), which
    # the beam keeps in its stall slots; rounds below come out infinite
    ici_c, dcn_c = cycle_cost(schedule, model, wire_fraction)
    rounds, _ = consensus_cost(gap, schedule.num_phases, 1)
    if math.isfinite(rounds):
        cycles = rounds / schedule.num_phases
        return _Eval(gap=gap, cycle_ici=ici_c, cycle_dcn=dcn_c,
                     priced=cycles * (ici_c + dcn_c),
                     ici_per_efold=cycles * ici_c,
                     dcn_per_efold=cycles * dcn_c)
    return _Eval(gap=gap, cycle_ici=ici_c, cycle_dcn=dcn_c,
                 priced=math.inf, ici_per_efold=math.inf,
                 dcn_per_efold=0.0)


# -- the search --------------------------------------------------------------


def synthesize(world: int, interconnect: InterconnectModel | None = None,
               wire_fraction: float = 1.0,
               config: SynthesisConfig | None = None,
               floor: float = DEFAULT_GAP_FLOOR,
               seed_specs=()) -> SynthesisResult | None:
    """Beam-search a phase composition for ``world`` ranks on the priced
    fabric.  Returns the best floor-clearing cycle found within the
    evaluation budget, or None when nothing clears the floor.

    ``seed_specs`` (e.g. the spec stamped into a resumed run's plan) are
    evaluated first as complete candidates — a replan at an
    unchanged world reuses the stamped schedule unless the fresh search
    strictly beats it.
    """
    cfg = config or SynthesisConfig()
    model = interconnect or UNIFORM
    if world < 2:
        return None
    rng = np.random.default_rng(cfg.seed)
    moves = _move_library(world, model, cfg, rng)
    evals = 0
    best: SynthesisResult | None = None

    def consider(state: _State, from_seed: bool) -> None:
        nonlocal best
        ev = state.ev
        if ev.gap < floor or not math.isfinite(ev.priced):
            return
        if best is None or (ev.priced, state.key) < (best.priced_cost,
                                                     best.key):
            best = SynthesisResult(
                spec=validate_spec({"v": SPEC_VERSION, "world": world,
                                    "phases": list(state.phases)}),
                gap=ev.gap, priced_cost=ev.priced,
                ici_per_efold=ev.ici_per_efold,
                dcn_per_efold=ev.dcn_per_efold,
                num_phases=len(state.phases), evals=evals, key=state.key,
                from_seed_spec=from_seed)

    for spec in seed_specs:
        try:
            norm = validate_spec(spec, world)
        except ValueError:
            continue   # stamped for another world: re-search
        ev = _evaluate(world, tuple(norm["phases"]), model, wire_fraction)
        evals += 1
        if ev is not None:
            # the empty key sorts before every move key, so a searched
            # candidate displaces the stamp only by STRICTLY better
            # priced cost — reuse-unless-beaten, exactly as documented
            consider(_State(tuple(norm["phases"]), "", ev), True)

    frontier: list[_State] = []
    for key, phase in moves:
        if evals >= cfg.budget:
            break
        ev = _evaluate(world, (phase,), model, wire_fraction)
        evals += 1
        if ev is None:
            continue
        st = _State((phase,), key, ev)
        frontier.append(st)
        consider(st, False)

    for _depth in range(2, cfg.max_phases + 1):
        if evals >= cfg.budget or not frontier:
            break
        # contracting prefixes by objective; zero-gap prefixes by cycle
        # cost (a psum or delegate phase alone does not contract yet but
        # is one move from the best schedules)
        finite = sorted((s for s in frontier
                         if math.isfinite(s.ev.priced)),
                        key=lambda s: (s.ev.priced, s.key))
        stalled = sorted((s for s in frontier
                          if not math.isfinite(s.ev.priced)),
                         key=lambda s: (s.ev.cycle_ici + s.ev.cycle_dcn,
                                        s.key))
        frontier = (finite[:cfg.beam_width]
                    + stalled[:cfg.stall_width])
        nxt: list[_State] = []
        for st in frontier:
            for key, phase in moves:
                if evals >= cfg.budget:
                    break
                if phase == st.phases[-1] and phase["kind"] == "psum":
                    continue   # psum ∘ same psum is the same matrix
                ev = _evaluate(world, st.phases + (phase,), model,
                               wire_fraction)
                evals += 1
                if ev is None:
                    continue
                child = _State(st.phases + (phase,),
                               st.key + ">" + key, ev)
                nxt.append(child)
                consider(child, False)
            if evals >= cfg.budget:
                break
        frontier = nxt

    if best is not None:
        best = dataclasses.replace(best, evals=evals)
    return best


# -- plan policy -------------------------------------------------------------


def plan_synthesized(world: int, ppi: int | None = None,
                     algorithm: str = "sgp",
                     floor: float = DEFAULT_GAP_FLOOR,
                     interconnect: InterconnectModel | None = None,
                     wire: dict | None = None,
                     global_avg_every: int | None = None,
                     overlap: bool = False, faults: bool = False,
                     self_weighted=False,
                     config: SynthesisConfig | None = None,
                     stamped_spec: dict | None = None):
    """``--topology synth``: search, compare against the registry, and
    return a :class:`~.policy.Plan` — the synthesized winner when it
    strictly beats the cheapest floor-clearing registry candidate on
    priced cost per consensus e-fold, else the registry plan with the
    attempt noted (synthesis never regresses a launch).

    ``stamped_spec`` (from a resumed checkpoint or a recovery replan)
    participates as a seed candidate, so an unchanged world reuses the
    stamped schedule instead of falling back to the registry.
    """
    from .policy import Plan, PlanConstraints, _wire_fraction, plan_for

    if algorithm != "sgp":
        raise ValueError(
            "synthesized schedules are irregular (push-sum only); "
            f"algorithm={algorithm!r} needs a doubly-stochastic registry "
            "schedule")
    if overlap:
        raise ValueError(
            "overlap is not supported with --topology synth: a "
            "psum/ppermute phase composition has no single augmented "
            "in-flight table form (use a registry topology for overlap "
            "runs)")
    if faults:
        raise ValueError(
            "fault injection is not supported with --topology synth: "
            "grouped psum phases have no per-edge mask (use a flat "
            "registry topology for fault drills)")
    if self_weighted:
        raise ValueError(
            "--mixing_alpha does not compose with --topology synth: "
            "the searched spec already fixes every per-rank weight")
    cfg = config or SynthesisConfig()
    fallback = plan_for(world, ppi=ppi, algorithm=algorithm,
                        constraints=PlanConstraints(
                            floor=floor, interconnect=interconnect,
                            wire=wire),
                        global_avg_every=global_avg_every)
    if world < 2:
        return fallback
    wf = _wire_fraction(wire)
    seeds = (stamped_spec,) if stamped_spec else ()
    result = synthesize(world, interconnect=interconnect,
                        wire_fraction=wf, config=cfg, floor=floor,
                        seed_specs=seeds)
    peer_counts = (int(ppi),) if ppi else DEFAULT_PEER_COUNTS
    regs = score_candidates(world, peer_counts, floor=floor,
                            interconnect=interconnect, wire_fraction=wf)
    bar = min((c.priced_cost for c in regs if c.meets(floor)),
              default=math.inf)
    if result is None or not result.priced_cost < bar:
        searched = (f"searched {result.evals} candidates, best "
                    f"{result.priced_cost:.1f}" if result is not None
                    else "search found no floor-clearing cycle")
        return dataclasses.replace(
            fallback,
            rationale=fallback.rationale
            + f"; synthesis did not beat the registry ({searched} vs "
              f"registry {bar:.1f} priced/e-fold) — keeping the "
              "registry plan")
    cand = evaluate_candidate(
        functools.partial(SynthesizedGraph, spec=result.spec), world,
        int(ppi) if ppi else 1, interconnect=interconnect,
        wire_fraction=wf)
    kinds = [ph["kind"] for ph in result.spec["phases"]]
    gae = max(0, global_avg_every or 0)
    rationale = (
        f"synthesized {result.num_phases}-phase cycle "
        f"[{'+'.join(kinds)}]: gap {result.gap:.4f}, priced "
        f"{result.priced_cost:.1f}/e-fold (ICI "
        f"{result.ici_per_efold:.1f} + DCN {result.dcn_per_efold:.1f}) "
        f"beats best registry {regs[0].topology} (ppi {regs[0].ppi}) at "
        f"{bar:.1f}; {result.evals} candidates searched, seed {cfg.seed}"
        + (", reusing the stamped spec" if result.from_seed_spec else ""))
    if gae:
        rationale += (f"; exact global average every {gae} step(s) by "
                      "user request")
    return Plan(
        world=world, ppi=int(ppi) if ppi else 1, topology="synth",
        mixing="synthesized", alpha=None, gap=result.gap, floor=floor,
        num_phases=result.num_phases, comm_cost=cand.comm_cost,
        global_avg_every=gae, algorithm="sgp", auto=True,
        rationale=rationale,
        ranking=(cand.to_dict(),) + tuple(c.to_dict()
                                          for c in regs[:7]),
        slice_size=None,
        interconnect=interconnect.to_dict() if interconnect else None,
        wire=wire,
        synth={**cfg.to_dict(), **result.to_dict(),
               "spec": result.spec})
