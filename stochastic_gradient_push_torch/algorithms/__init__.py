"""Decentralized data-parallel training algorithms: AllReduce, SGP, OSGP,
D-PSGD and AD-PSGD."""

from .api import GossipAlgorithm, GossipState
from .algorithms import (AllReduce, BilateralGossip, PushPullGossip,
                         PushSumGossip, adpsgd, all_reduce, dpsgd,
                         drain_in_flight, drain_state, osgp, sgp)

__all__ = ["GossipAlgorithm", "GossipState", "AllReduce", "PushSumGossip",
           "PushPullGossip", "BilateralGossip", "all_reduce", "sgp", "osgp",
           "dpsgd", "adpsgd", "drain_in_flight", "drain_state"]
