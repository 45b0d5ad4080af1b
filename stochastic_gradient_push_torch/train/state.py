"""Explicit train state and the torch-semantics SGD update.

Port of ``stochastic_gradient_push_tpu/train/state.py``.  The state is
one value: the step counter, the rank-stacked parameters (the push-sum
numerators), the optimizer's momentum buffers, the
:class:`~..algorithms.api.GossipState` and the BatchNorm running
statistics (empty for the LM).
"""

from __future__ import annotations

import dataclasses

import torch

from ..algorithms.api import GossipState

__all__ = ["TrainState", "SGD", "sgd"]


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Complete training state of the ranks this process holds.

    Attributes:
      step: global iteration counter.
      params: ``{name: tensor [R, ...]}`` model parameters, the push-sum
        *numerator* for SGP (the optimizer steps these directly).
      opt_state: ``{name: tensor [R, ...]}`` SGD momentum buffers.
      gossip: :class:`GossipState`.
      batch_stats: ``{buffer name: tensor [R, C]}`` BatchNorm running
        statistics, rank-local and never gossiped (the reference keeps
        BN buffers rank-local too); empty for models without BatchNorm.
    """

    step: int
    params: dict
    opt_state: dict
    gossip: GossipState
    batch_stats: dict = dataclasses.field(default_factory=dict)


class SGD:
    """SGD with the exact ``torch.optim.SGD`` update rule the reference
    uses (its ``sgd``, train/state.py:49-55 there)::

        d   = grad + wd * p
        buf = d + momentum * buf
        d   = d + momentum * buf   (nesterov)  |  buf  (otherwise)

    The caller applies ``p -= lr * d``.  Weight decay applies to every
    parameter, as the reference's single param group does.
    """

    def __init__(self, momentum: float = 0.9, weight_decay: float = 1e-4,
                 nesterov: bool = False):
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.nesterov = bool(nesterov)

    def init(self, params: dict) -> dict:
        return {n: torch.zeros_like(p) for n, p in params.items()}

    def update(self, grads: dict, bufs: dict, params: dict):
        """``(updates, new_bufs)``; ops in the reference's order
        (optax ``add_decayed_weights`` then ``trace``)."""
        updates, new_bufs = {}, {}
        for n, g in grads.items():
            d = g + self.weight_decay * params[n]
            buf = d + self.momentum * bufs[n]
            new_bufs[n] = buf
            updates[n] = d + self.momentum * buf if self.nesterov else buf
        return updates, new_bufs


def sgd(momentum: float = 0.9, weight_decay: float = 1e-4,
        nesterov: bool = False) -> SGD:
    return SGD(momentum, weight_decay, nesterov)
