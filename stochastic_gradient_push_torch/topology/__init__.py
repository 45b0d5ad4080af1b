"""Gossip communication topologies, mixing strategies and schedules
(copies of the reference's numpy modules; flat graphs 0–5)."""

from .graphs import (
    GraphTopology,
    DynamicDirectedExponentialGraph,
    NPeerDynamicDirectedExponentialGraph,
    DynamicBipartiteExponentialGraph,
    DynamicDirectedLinearGraph,
    DynamicBipartiteLinearGraph,
    RingGraph,
)
from .mixing import MixingStrategy, SelfWeightedMixing, UniformMixing
from .schedule import GossipSchedule, build_pairing_schedule, build_schedule

# the reference's integer registry (topology/__init__.py:31-39), graphs
# 0-5; 6 (HierarchicalGraph) is not ported yet
GRAPH_TOPOLOGIES = {
    0: DynamicDirectedExponentialGraph,
    1: DynamicBipartiteExponentialGraph,
    2: DynamicDirectedLinearGraph,
    3: DynamicBipartiteLinearGraph,
    4: RingGraph,
    5: NPeerDynamicDirectedExponentialGraph,
}

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
    "MixingStrategy",
    "UniformMixing",
    "SelfWeightedMixing",
    "GossipSchedule",
    "build_schedule",
    "build_pairing_schedule",
    "GRAPH_TOPOLOGIES",
    "MIXING_STRATEGIES",
]
