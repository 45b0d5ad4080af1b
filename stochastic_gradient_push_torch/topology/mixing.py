"""Mixing-weight strategies for gossip averaging.

A copy of ``stochastic_gradient_push_tpu/topology/mixing.py`` (numpy
only).  Mirrors the semantics of the original SGP code's
``gossip/mixing_manager.py:19-56``:
a mixing strategy assigns, for the current set of out-peers, the weight kept
locally (``lo``) and the weight attached to each outgoing message.  The
reference returns a dict keyed by peer rank; here weights are plain floats
arranged per rotation phase, ready to be baked into a gossip round.

``is_regular`` (mixing_manager.py:25-30) — uniform weights on a regular graph
— is the condition under which the push-sum weight provably stays at 1.0
after every *complete* synchronous gossip round, which the algorithm layer
exploits the same way the reference's "lazy mixing" does
(distributed.py:188-191), except here it falls out algebraically instead of
via stateful bias/de-bias flags.
"""

from __future__ import annotations

import numpy as np

from .graphs import GraphTopology

__all__ = ["MixingStrategy", "UniformMixing", "SelfWeightedMixing"]


class MixingStrategy:
    """Assigns mixing weights to the local loopback and each out-edge."""

    def is_uniform(self) -> bool:
        raise NotImplementedError

    def is_regular(self, graph: GraphTopology) -> bool:
        """True iff the mixing matrix's stationary distribution is uniform,
        i.e. no bias accumulates in the push-sum weight."""
        return graph.is_regular_graph() and self.is_uniform()

    def weights(self, graph: GraphTopology, phase: int
                ) -> tuple[np.ndarray, np.ndarray]:
        """Returns per-rank weight tables for a phase:
        ``(self_weight[world], edge_weights[peers_per_itr, world])`` —
        entry ``[..., r]`` is the weight rank ``r`` applies.

        Column-stochasticity — ``self_weight[r] + edge_weights[:, r].sum()
        == 1`` for every rank — is what push-sum requires for mass
        conservation.
        """
        raise NotImplementedError


class UniformMixing(MixingStrategy):
    """Uniform 1/(out_degree + 1) allocation (mixing_manager.py:41-56)."""

    def is_uniform(self) -> bool:
        return True

    def weights(self, graph: GraphTopology, phase: int
                ) -> tuple[np.ndarray, np.ndarray]:
        n = graph.world_size
        deg = graph.peers_per_itr if n > 1 else 0
        w = 1.0 / (deg + 1.0)
        return (np.full((n,), w, dtype=np.float64),
                np.full((deg, n), w, dtype=np.float64))


class SelfWeightedMixing(MixingStrategy):
    """Column-stochastic mixing with per-rank self weights.

    Rank ``r`` keeps ``alpha[r]`` of its mass and sends
    ``(1 - alpha[r])/deg`` along each out-edge.  With rank-dependent alphas
    the mixing matrix is column- but not row-stochastic, so the stationary
    distribution is non-uniform and the push-sum weight genuinely deviates
    from 1 — the *irregular* regime the reference gates with
    ``MixingManager.is_regular`` (mixing_manager.py:25-30) and handles by
    appending the ps-weight to the payload (gossiper.py:83-85).  Here it
    exercises the always-on ps-weight lane: de-biased estimates still
    converge to the true average, the guarantee push-sum exists to provide.

    A larger alpha means lazier communication for that rank (more self-mass
    per round) — e.g. ranks on slow links can gossip less aggressively.

    Args:
      alpha: scalar in (0, 1) applied to every rank, or a per-rank
        sequence of such values.
    """

    def __init__(self, alpha=0.5):
        self.alpha = np.atleast_1d(np.asarray(alpha, dtype=np.float64))
        if np.any(self.alpha <= 0.0) or np.any(self.alpha >= 1.0):
            raise ValueError("alpha values must be in (0, 1)")

    def is_uniform(self) -> bool:
        return False

    def weights(self, graph: GraphTopology, phase: int
                ) -> tuple[np.ndarray, np.ndarray]:
        n = graph.world_size
        deg = graph.peers_per_itr if n > 1 else 0
        if self.alpha.size == 1:
            alpha = np.full((n,), float(self.alpha[0]))
        elif self.alpha.size == n:
            alpha = self.alpha.copy()
        else:
            raise ValueError(
                f"alpha has {self.alpha.size} entries for world_size {n}")
        return alpha, np.broadcast_to((1.0 - alpha) / deg, (deg, n)).copy()
