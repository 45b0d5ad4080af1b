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
from .schedule import GossipSchedule, build_schedule

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
    "GRAPH_TOPOLOGIES",
]
