"""AllReduce and synchronous Stochastic Gradient Push.

Port of ``AllReduce`` and the synchronous path of ``PushSumGossip`` in
``stochastic_gradient_push_tpu/algorithms/algorithms.py``, with the
``all_reduce`` and ``sgp`` factories.  Where the reference takes a mesh
axis name, the port takes a transport (``parallel/collectives.py``).

Not ported yet, and refused by name: overlap (OSGP), staleness,
communication thinning (``gossip_every > 1``), periodic global
averaging, fault injection, error feedback, the gossip kernel lane and
transport buckets; D-PSGD (``PushPullGossip``) and AD-PSGD
(``BilateralGossip``).
"""

from __future__ import annotations

from ..parallel import collectives
from ..topology.schedule import GossipSchedule
from .api import GossipAlgorithm, GossipState

__all__ = ["AllReduce", "PushSumGossip", "all_reduce", "sgp"]


class AllReduce(GossipAlgorithm):
    """Exact AllReduce-SGD baseline: average gradients every step."""

    name = "ar"

    def __init__(self, transport):
        self.transport = transport

    def reduce_grads(self, grads: dict) -> dict:
        return collectives.allreduce_mean(grads, self.transport)


def _not_ported(feature: str):
    raise NotImplementedError(
        f"{feature} is not ported to stochastic_gradient_push_torch yet "
        f"(a later slice of the port; ROADMAP.md Queue 1)")


class PushSumGossip(GossipAlgorithm):
    """Synchronous Stochastic Gradient Push: after the optimizer step, one
    complete push-sum round mixes the parameters (the push-sum
    numerators) and the push-sum weight jointly; the forward sees the
    de-biased ``params / ps_weight``."""

    name = "sgp"

    def __init__(self, schedule: GossipSchedule, transport,
                 overlap: bool = False, gossip_every: int = 1,
                 staleness: int = 1, global_avg_every: int = 0,
                 faults=None, wire=None, error_feedback: bool = False,
                 gossip_kernel=None, gossip_buckets: int = 1):
        if overlap:
            _not_ported("overlap (OSGP)")
        if staleness != 1:
            _not_ported("staleness")
        if gossip_every != 1:
            _not_ported("communication thinning (gossip_every > 1)")
        if global_avg_every:
            _not_ported("periodic global averaging (global_avg_every)")
        if faults is not None:
            _not_ported("fault injection")
        if error_feedback:
            _not_ported("error feedback")
        if gossip_kernel not in (None, "xla"):
            _not_ported(f"the gossip kernel lane ({gossip_kernel!r})")
        if gossip_buckets != 1:
            _not_ported("transport buckets (gossip_buckets)")
        self.schedule = schedule
        self.transport = transport
        self.wire = wire

    def eval_params(self, params: dict, state: GossipState) -> dict:
        w = state.ps_weight
        return {n: p / w.reshape((-1,) + (1,) * (p.dim() - 1)).to(p.dtype)
                for n, p in params.items()}

    def post_step(self, params: dict, state: GossipState):
        params, ps_weight = collectives.mix_push_sum(
            params, state.ps_weight, state.phase, self.schedule,
            self.transport, codec=self.wire)
        return params, state.replace(phase=state.phase + 1,
                                     ps_weight=ps_weight)


def all_reduce(transport) -> AllReduce:
    return AllReduce(transport)


def sgp(schedule: GossipSchedule, transport, **kwargs) -> PushSumGossip:
    return PushSumGossip(schedule, transport, **kwargs)
