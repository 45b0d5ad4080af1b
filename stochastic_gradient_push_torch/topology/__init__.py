"""Gossip communication topologies, mixing strategies and schedules
(copies of the reference's numpy modules: the flat graphs 0–5, the
hierarchical graph 6 and synthesized schedules)."""

import functools

from .graphs import (
    GraphTopology,
    DynamicDirectedExponentialGraph,
    NPeerDynamicDirectedExponentialGraph,
    DynamicBipartiteExponentialGraph,
    DynamicDirectedLinearGraph,
    DynamicBipartiteLinearGraph,
    RingGraph,
)
from .hierarchical import (
    HierarchicalGraph,
    HierarchicalSchedule,
    default_slice_size,
)
from .mixing import MixingStrategy, SelfWeightedMixing, UniformMixing
from .schedule import GossipSchedule, build_pairing_schedule, build_schedule
from .synthesized import (
    SynthesizedGraph,
    SynthesizedSchedule,
    spec_fingerprint,
    validate_spec,
)

# the reference's integer registry (topology/__init__.py:31-39); -1 is
# no graph (AllReduce)
GRAPH_TOPOLOGIES = {
    0: DynamicDirectedExponentialGraph,
    1: DynamicBipartiteExponentialGraph,
    2: DynamicDirectedLinearGraph,
    3: DynamicBipartiteLinearGraph,
    4: RingGraph,
    5: NPeerDynamicDirectedExponentialGraph,
    6: HierarchicalGraph,
    -1: None,
}

# the name registry of the planner and ``--topology``; "synth" is built
# from a spec only, so the planner's registry scan skips it
TOPOLOGY_NAMES = {
    "exponential": DynamicDirectedExponentialGraph,
    "bipartite-exponential": DynamicBipartiteExponentialGraph,
    "linear": DynamicDirectedLinearGraph,
    "bipartite-linear": DynamicBipartiteLinearGraph,
    "ring": RingGraph,
    "npeer-exponential": NPeerDynamicDirectedExponentialGraph,
    "hierarchical": HierarchicalGraph,
    "synth": SynthesizedGraph,
}


def topology_name(graph_class) -> str:
    """The registered name of a topology class (inverse of
    :data:`TOPOLOGY_NAMES`); a ``functools.partial`` over a registered
    class (a plan's bound slice decomposition or spec) names its class."""
    if isinstance(graph_class, functools.partial):
        graph_class = graph_class.func
    for name, cls in TOPOLOGY_NAMES.items():
        if cls is graph_class:
            return name
    raise KeyError(f"{graph_class!r} is not a registered topology")


# the reference's mixing registry (``--mixing_strategy``); -1 is no mixing
# (AllReduce)
MIXING_STRATEGIES = {
    0: UniformMixing,
    -1: None,
}

__all__ = [
    "GraphTopology",
    "DynamicDirectedExponentialGraph",
    "NPeerDynamicDirectedExponentialGraph",
    "DynamicBipartiteExponentialGraph",
    "DynamicDirectedLinearGraph",
    "DynamicBipartiteLinearGraph",
    "RingGraph",
    "HierarchicalGraph",
    "HierarchicalSchedule",
    "SynthesizedGraph",
    "SynthesizedSchedule",
    "default_slice_size",
    "spec_fingerprint",
    "validate_spec",
    "MixingStrategy",
    "UniformMixing",
    "SelfWeightedMixing",
    "GossipSchedule",
    "build_schedule",
    "build_pairing_schedule",
    "GRAPH_TOPOLOGIES",
    "MIXING_STRATEGIES",
    "TOPOLOGY_NAMES",
    "topology_name",
]
