"""Port parity: gossip without a model (``parallel/averaging.py``) and the
flat views of trees (``utils/flatten.py``) against the reference's.

* ``push_sum_average`` at world 8 on ``StackedTransport`` against the
  reference's compiled program on ``make_gossip_mesh(8)``, bit for bit,
  for ``tests/test_averaging_thinning.py``'s two schedules (the n-peer
  exponential graph, 50 rounds, and ``SelfWeightedMixing`` with
  irregular alphas, 120 rounds), from phase 0 and from phase 3, on a
  dict whose keys are not in sorted order, a nested tree and a bare
  leaf; and on ``DistTransport`` in 2 gloo processes against the
  stacked world 2; ``consensus_error`` equal to the reference's.
* ``flatten_tensors`` / ``unflatten_tensors``: a round trip, and the
  flat buffer equal to the reference's ``ravel_pytree`` element for
  element on trees whose dict keys are not sorted (mixed dtypes
  promote as the reference's do); ``group_by_dtype``, ``communicate``
  (a doubling op), ``global_norm`` (1e-6 relative: each framework sums
  a leaf in its own order) and ``is_power_of`` equal to the
  reference's.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.parallel.averaging import (
    consensus_error, push_sum_average)
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch import topology as ttopo
from stochastic_gradient_push_torch.utils import flatten as tflat

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
ALPHAS = 0.3 + 0.5 * np.arange(WORLD) / (WORLD - 1)
# tests/test_averaging_thinning.py's schedules and round counts
SCHEDULES = {"exponential": (None, 50), "irregular": (ALPHAS, 120)}


def _schedules(name, world=WORLD):
    from stochastic_gradient_push_tpu import topology as jtopo

    alphas, rounds = SCHEDULES[name]
    out = []
    for topo in (jtopo, ttopo):
        graph = topo.NPeerDynamicDirectedExponentialGraph(world,
                                                          peers_per_itr=1)
        mixing = (topo.SelfWeightedMixing(alpha=alphas[:world])
                  if alphas is not None else None)
        out.append(topo.build_schedule(graph, mixing))
    return (*out, rounds)


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    normal = lambda *s: rng.normal(size=(WORLD, *s)).astype(np.float32)
    return {"unsorted": {"w": normal(3, 2), "b": normal(5), "a": normal(1)},
            "nested": {"z": [normal(2), (normal(3, 3),)],
                       "m": {"y": normal(4), "x": normal(2, 2)}},
            "leaf": normal(4)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch(v) for v in tree)
    return torch.from_numpy(tree.copy())


def _pairs(port, ref):
    """(port leaf, reference leaf) pairs, the reference's leaf order."""
    return list(zip(tflat.tree_leaves(port), jax.tree.leaves(ref)))


@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("tree_name", sorted(_trees()))
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_push_sum_average_is_bit_equal_to_the_reference(schedule,
                                                        tree_name, start):
    from stochastic_gradient_push_tpu.parallel import (
        consensus_error as jce, make_gossip_mesh, push_sum_average as jpsa)

    jsched, tsched, rounds = _schedules(schedule)
    tree = _trees()[tree_name]
    want = jax.device_get(jpsa(tree, make_gossip_mesh(WORLD), jsched,
                               rounds=rounds, start_phase=start))
    got = push_sum_average(_torch(tree), StackedTransport(WORLD), tsched,
                           rounds=rounds, start_phase=start)
    assert type(got) is type(_torch(tree))
    if isinstance(tree, dict):
        assert list(got) == list(tree)      # the caller's key order
    for g, w in _pairs(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert consensus_error(got) == jce(want)
    assert consensus_error(_torch(tree)) == jce(tree)
    assert consensus_error(got) < 1e-5 < 0.5 < consensus_error(_torch(tree))


def test_push_sum_average_refuses_a_schedule_of_another_world():
    _, tsched, _ = _schedules("exponential")
    with pytest.raises(ValueError, match="world_size=8 but the transport "
                                         "holds world 4"):
        push_sum_average({"a": torch.zeros(4, 2)}, StackedTransport(4),
                         tsched, rounds=1)


_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
from stochastic_gradient_push_torch.parallel import collectives, multihost
from stochastic_gradient_push_torch.parallel.averaging import (
    push_sum_average)
from stochastic_gradient_push_torch import topology

multihost.initialize_multihost("gloo", "cpu")
transport = collectives.DistTransport()
r = transport.rank
alphas = json.loads(sys.argv[2])
tree = {k: torch.from_numpy(np.asarray(v, np.float32)[r:r + 1])
        for k, v in json.loads(sys.argv[3]).items()}
sched = topology.build_schedule(
    topology.NPeerDynamicDirectedExponentialGraph(2, peers_per_itr=1),
    topology.SelfWeightedMixing(alpha=np.asarray(alphas)))
out = push_sum_average(tree, transport, sched, rounds=7, start_phase=1)
print("OUT " + json.dumps({k: v[0].tolist() for k, v in out.items()}),
      flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def test_push_sum_average_across_processes_equals_stacked():
    """One rank per process (gloo), an irregular schedule: every
    process's de-biased rows bit-equal to the stacked world 2's."""
    alphas = [0.3, 0.7]
    rng = np.random.default_rng(4)
    tree = {"b": rng.normal(size=(2, 3)).astype(np.float32),
            "a": rng.normal(size=(2, 2, 2)).astype(np.float32)}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, REPO, json.dumps(alphas),
         json.dumps({k: v.tolist() for k, v in tree.items()})],
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                 RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    sched = ttopo.build_schedule(
        ttopo.NPeerDynamicDirectedExponentialGraph(2, peers_per_itr=1),
        ttopo.SelfWeightedMixing(alpha=np.asarray(alphas)))
    want = push_sum_average(_torch(tree), StackedTransport(2), sched,
                            rounds=7, start_phase=1)
    for r, log in enumerate(logs):
        line = next(x for x in log.splitlines() if x.startswith("OUT "))
        got = json.loads(line[4:])
        for k, t in want.items():
            np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                          t[r].numpy())


# -- utils/flatten.py ----------------------------------------------------------

def _flat_trees():
    rng = np.random.default_rng(3)
    return {
        "unsorted": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                     "b": rng.normal(size=5).astype(np.float32),
                     "a": rng.normal(size=()).astype(np.float32)},
        "nested": {"z": [rng.normal(size=2).astype(np.float32),
                         (rng.normal(size=(2, 2)).astype(np.float32),)],
                   "m": {"y": rng.normal(size=4).astype(np.float32)}},
        "mixed": {"k": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "f": rng.normal(size=3).astype(np.float32)},
    }


@pytest.mark.parametrize("name", sorted(_flat_trees()))
def test_flatten_equals_ravel_pytree_and_round_trips(name):
    from stochastic_gradient_push_tpu.utils import flatten as jflat

    tree = _flat_trees()[name]
    want, _ = jflat.flatten_tensors(tree)
    flat, unravel = tflat.flatten_tensors(_torch(tree))
    assert str(flat.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = tflat.unflatten_tensors(flat, unravel)
    for g, w in _pairs(back, tree):
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # the caller's structure and key order come back
    assert json.dumps(jax.tree.map(lambda _: 0, tree)) == json.dumps(
        jax.tree.map(lambda _: 0, _structure(back)))
    if isinstance(tree, dict):
        assert list(back) == list(tree)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_structure(v) for v in tree)
    return 0


def test_flatten_of_an_empty_tree():
    flat, unravel = tflat.flatten_tensors({"a": [], "b": None})
    assert flat.numel() == 0
    assert unravel(flat) == {"a": [], "b": None}


@pytest.mark.parametrize("name", sorted(_flat_trees()))
def test_group_by_dtype_communicate_and_norm_equal_the_reference(name):
    from stochastic_gradient_push_tpu.utils import flatten as jflat

    tree = _flat_trees()[name]
    want = jflat.group_by_dtype(tree)
    got = tflat.group_by_dtype(_torch(tree))
    assert [str(d).split(".")[-1] for d in got] == [str(d) for d in want]
    for g, w in zip(got.values(), want.values()):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jflat.communicate(tree, lambda x: x * 2)
    got = tflat.communicate(_torch(tree), lambda x: x * 2)
    for g, w in _pairs(got, want):
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(float(tflat.global_norm(_torch(tree))),
                               float(jflat.global_norm(tree)), rtol=1e-6)


def test_global_norm_of_nothing_and_is_power_of():
    from stochastic_gradient_push_tpu.utils import flatten as jflat

    assert float(tflat.global_norm({})) == float(jflat.global_norm({})) == 0
    for n in (1, 2, 3, 4, 8, 9, 12, 27, 64, 81, 100, 1024):
        for k in (0, 1, 2, 3, 4, 10):
            assert tflat.is_power_of(n, k) == jflat.is_power_of(n, k), (n, k)
    for bad in ((0, 2), (-4, 2), (4, -1), (2.0, 2)):
        with pytest.raises(ValueError) as want:
            jflat.is_power_of(*bad)
        with pytest.raises(ValueError, match=str(want.value)):
            tflat.is_power_of(*bad)
