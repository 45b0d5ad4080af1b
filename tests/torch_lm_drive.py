"""Shared pieces of the port's LM parity tests (``test_torch_train_lm``
and ``test_torch_train_lm_sp``, where the tolerances' reasons are
written): an fp64 copy of a train state (the exact oracle's start), tree
distances, the OSGP momentum check, the bf16 params check and the bf16
loss tolerance."""

import dataclasses

import numpy as np
import torch

# OSGP momentum after three steps: both frameworks sit 1.48-1.71e-6 from
# an fp64 run, so twice the larger distance
MOM_ATOL = 4e-6
# bf16 losses against the reference's bf16 losses (relative)
BF16_LOSS_RTOL = 2e-3


def fp64_state(state):
    """``state`` with its params, momentum, push-sum weight and in-flight
    shares in fp64, for a step of a ``dtype=torch.float64`` model."""
    def up(tree):
        return {n: t.double() for n, t in tree.items()}

    g = state.gossip
    g = g.replace(ps_weight=g.ps_weight.double(),
                  in_flight=None if g.in_flight is None else tuple(
                      (up(p), w.double()) for p, w in g.in_flight))
    return dataclasses.replace(state, params=up(state.params),
                               opt_state=up(state.opt_state), gossip=g)


def tree_err(a: dict, b: dict) -> float:
    """Largest absolute difference over the leaves of ``b``."""
    return max(float((a[n].double() - b[n].double()).abs().max()) for n in b)


def assert_momentum(got: dict, want: dict, exact: dict):
    """The port's momentum within :data:`MOM_ATOL` of the reference's, and
    no farther from the fp64 run's than twice the reference's, plus
    1e-7."""
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=MOM_ATOL, err_msg=name)
    assert tree_err(got, exact) <= 2 * tree_err(want, exact) + 1e-7


def assert_bf16_params(got: dict, ref16: dict, ref32: dict):
    """The port's params after bf16 steps between half and twice the
    reference's bf16 run's distance from its fp32 run (plus 1e-5), away
    from the fp32 run: bf16 ran on both sides."""
    ref_dist = tree_err(ref16, ref32)
    assert 0.5 * ref_dist <= tree_err(got, ref32) <= 2 * ref_dist + 1e-5
