"""Decentralized data-parallel training algorithms (AllReduce and
synchronous SGP so far)."""

from .api import GossipAlgorithm, GossipState
from .algorithms import AllReduce, PushSumGossip, all_reduce, sgp

__all__ = ["GossipAlgorithm", "GossipState", "AllReduce", "PushSumGossip",
           "all_reduce", "sgp"]
