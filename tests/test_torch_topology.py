"""Port parity: the topology copies (``stochastic_gradient_push_torch.
topology``) build the same gossip schedules as the JAX package's numpy
modules, entry for entry (``array_equal``; exact).

Over world 2–64 × peers_per_itr {1, 2} for each flat graph of the
integer registry (0–5), and for uniform and self-weighted mixing: the
permutation tables, the self and edge weights, ``regular``, the phase
count and the dense mixing matrices.  Where the reference refuses a
world (bipartite graphs at an odd world, ppi past the phone book) the
port refuses it with the same error type.
"""

import numpy as np
import pytest

from stochastic_gradient_push_torch import topology as tt

WORLDS = range(2, 65)


def _both(ref_fn, port_fn):
    try:
        want = ref_fn()
    except ValueError:
        with pytest.raises(ValueError):
            port_fn()
        return None, None
    return want, port_fn()


def _assert_same(want, got):
    np.testing.assert_array_equal(got.perms, want.perms)
    np.testing.assert_array_equal(got.self_weight, want.self_weight)
    np.testing.assert_array_equal(got.edge_weights, want.edge_weights)
    assert (got.regular, got.world_size, got.peers_per_itr,
            got.num_phases) == (want.regular, want.world_size,
                                want.peers_per_itr, want.num_phases)


@pytest.mark.parametrize("ppi", [1, 2])
@pytest.mark.parametrize("graph_type", range(6))
def test_schedules_equal_reference(graph_type, ppi):
    from stochastic_gradient_push_tpu import topology as rt

    built = 0
    for world in WORLDS:
        want, got = _both(
            lambda: rt.build_schedule(
                rt.GRAPH_TOPOLOGIES[graph_type](world, peers_per_itr=ppi)),
            lambda: tt.build_schedule(
                tt.GRAPH_TOPOLOGIES[graph_type](world, peers_per_itr=ppi)))
        if want is None:
            continue
        _assert_same(want, got)
        built += 1
    assert built > 0


@pytest.mark.parametrize("graph_type", [0, 5])
def test_self_weighted_schedules_and_mixing_matrices_equal_reference(
        graph_type):
    from stochastic_gradient_push_tpu import topology as rt

    for world in (2, 3, 8, 12, 16):
        alpha = np.linspace(0.2, 0.8, world)
        want = rt.build_schedule(rt.GRAPH_TOPOLOGIES[graph_type](world, 1),
                                 rt.SelfWeightedMixing(alpha))
        got = tt.build_schedule(tt.GRAPH_TOPOLOGIES[graph_type](world, 1),
                                tt.SelfWeightedMixing(alpha))
        _assert_same(want, got)
        for p in range(want.num_phases):
            np.testing.assert_array_equal(got.mixing_matrix(p),
                                          want.mixing_matrix(p))


def test_world_one_schedule_is_the_identity():
    s = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(1))
    assert (s.world_size, s.num_phases) == (1, 1)
    np.testing.assert_array_equal(s.mixing_matrix(0), np.ones((1, 1)))
