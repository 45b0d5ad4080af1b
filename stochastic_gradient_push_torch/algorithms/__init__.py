"""Decentralized data-parallel training algorithms (AllReduce, SGP and
OSGP so far)."""

from .api import GossipAlgorithm, GossipState
from .algorithms import (AllReduce, PushSumGossip, all_reduce, drain_in_flight,
                         drain_state, osgp, sgp)

__all__ = ["GossipAlgorithm", "GossipState", "AllReduce", "PushSumGossip",
           "all_reduce", "sgp", "osgp", "drain_in_flight", "drain_state"]
