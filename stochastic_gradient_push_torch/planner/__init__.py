"""Launch-time topology & mixing-schedule planner.

The analysis layer (``analysis/verifier.py``) makes gossip mixing
*measurable*: every registered topology's rotation-cycle spectral gap is
computed on CPU in milliseconds.  This package makes it *actionable* at launch:

* :mod:`.scorer` — enumerate and rank every (topology × peers_per_itr)
  candidate for a world size by gap and a priced communication-cost
  model;
* :mod:`.interconnect` — the torus-aware fabric cost model pricing each
  edge: ICI torus hops inside a slice, a flat (configurable, typically
  ~16×) DCN weight across slices — what lets the two-level
  ``hierarchical`` topology outrank flat graphs exactly when the fabric
  says DCN dominates;
* :mod:`.alpha` — co-optimize the SelfWeightedMixing alpha against the
  chosen topology (a small scalar search) instead of taking it as a free
  knob;
* :mod:`.policy` — the decision layer: ``plan_for`` auto-switches away
  from below-floor topologies and emits a periodic-global-averaging
  schedule when no pure-gossip candidate clears the floor;
  ``check_topology`` scores user-forced choices and attaches loud
  structured warnings; ``resolve_topology`` is the run layer's single
  entry point (``--topology auto``);
* :mod:`.synthesize` — the schedule *synthesizer* (``--topology
  synth``): a seeded deterministic beam search over compositions of
  ppermute edge phases and grouped exact-psum phases, maximizing
  spectral gap per priced byte on the fabric; falls back to the
  registry plan whenever the search does not strictly beat it;
Everything is plain numpy over small matrices — no devices — so
planning is free at launch.  A copy of ``stochastic_gradient_push_tpu/
planner/`` but for its offline CLI (``planner/cli.py``,
``scripts/plan.py``), which is not ported.
"""

from .alpha import alpha_gap, optimize_alpha
from .interconnect import (
    DEFAULT_DCN_COST,
    DEFAULT_ICI_COST,
    InterconnectModel,
    make_interconnect,
)
from .policy import (
    DEFAULT_GAP_FLOOR,
    Plan,
    PlanConstraints,
    check_topology,
    plan_for,
    resolve_topology,
)
from .scorer import (
    Candidate,
    DEFAULT_PEER_COUNTS,
    consensus_cost,
    cycle_cost,
    evaluate_candidate,
    score_candidates,
)
from .synthesize import (
    SynthesisConfig,
    SynthesisResult,
    plan_synthesized,
    synthesize,
)

__all__ = [
    "DEFAULT_DCN_COST",
    "DEFAULT_GAP_FLOOR",
    "DEFAULT_ICI_COST",
    "DEFAULT_PEER_COUNTS",
    "Candidate",
    "InterconnectModel",
    "Plan",
    "PlanConstraints",
    "SynthesisConfig",
    "SynthesisResult",
    "alpha_gap",
    "check_topology",
    "consensus_cost",
    "cycle_cost",
    "evaluate_candidate",
    "make_interconnect",
    "optimize_alpha",
    "plan_for",
    "plan_synthesized",
    "resolve_topology",
    "score_candidates",
    "synthesize",
]
