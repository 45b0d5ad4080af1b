"""Decentralized-averaging algorithms as four slots of the train step.

Port of ``stochastic_gradient_push_tpu/algorithms/api.py``.  Each
algorithm is four functions over an explicit :class:`GossipState`,
called by the train step at fixed points, in this order::

    params, gstate = alg.pre_step(params, gstate)
    z              = alg.eval_params(params, gstate)   # de-biased params
    grads          = alg.reduce_grads(grads)           # exact averaging
    params, gstate = alg.post_step(params, gstate)     # the gossip round

Parameters are dicts of rank-stacked tensors (dim 0 indexes the ranks
this process holds, see ``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["GossipState", "GossipAlgorithm"]


@dataclasses.dataclass(frozen=True)
class GossipState:
    """Per-rank algorithm state carried through the train step.

    Attributes:
      phase: rotation counter (a host int: every rank advances it
        together in a synchronous run).
      ps_weight: float32 ``[R]`` push-sum weights of the held ranks
        (distributed.py:134-136).  Stays exactly 1.0 for synchronous
        regular mixing.
      in_flight: the overlap (OSGP) FIFO of ``staleness`` slots, each
        ``(params, ps_weight)``: one round's incoming share awaiting its
        consume.  Empty for synchronous algorithms.  Between steps every
        slot holds plain tensors; inside a step the slot ``pre_step``
        fills may be a ``collectives.PendingShares``.
      ef_residual: ``{name: tensor [R, ...]}`` mirroring the params: the
        pending quantization error of error feedback (a lossy wire codec
        with ``error_feedback=True``), re-injected into the next round's
        send.  None without error feedback.
    """

    phase: int
    ps_weight: torch.Tensor
    in_flight: tuple = ()
    ef_residual: dict | None = None

    def replace(self, **changes) -> "GossipState":
        return dataclasses.replace(self, **changes)


def _ranks_of(params: dict) -> tuple[int, torch.device]:
    leaf = next(iter(params.values()))
    return leaf.shape[0], leaf.device


class GossipAlgorithm:
    """Base algorithm: exact data parallelism without gradient averaging
    (the slots are identities)."""

    name: str = "base"

    def init(self, params: dict) -> GossipState:
        ranks, device = _ranks_of(params)
        return GossipState(phase=0, ps_weight=torch.ones(
            ranks, dtype=torch.float32, device=device))

    def bind_layout(self, layout) -> None:
        """Told by the step builder where the reference keeps each of the
        model's leaves (``models/convert.py::reference_layout``); the
        base algorithm has no wire and ignores it."""

    def pre_step(self, params: dict, state: GossipState):
        return params, state

    def eval_params(self, params: dict, state: GossipState) -> dict:
        """De-biased parameter estimate used for the forward
        (≙ ``unbias``, distributed.py:307-314)."""
        return params

    def val_params(self, params: dict, state: GossipState) -> dict:
        """Parameters for validation: :meth:`eval_params`, with an
        overlap algorithm's in-flight shares drained first (the training
        state is untouched)."""
        return self.eval_params(params, state)

    def reduce_grads(self, grads: dict) -> dict:
        return grads

    def post_step(self, params: dict, state: GossipState):
        return params, state
