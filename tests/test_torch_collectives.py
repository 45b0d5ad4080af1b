"""Port parity: the synchronous push-sum round (``stochastic_gradient_push_
torch.parallel.collectives``) against the JAX package's ``mix_push_sum``
on its 8-device CPU mesh, and the ``torch.distributed`` lane against the
stacked lane.

* World 8, stacked lane, five consecutive rounds (phases 0–4) from the
  same numpy state, uniform and self-weighted mixing (the latter moves
  the push-sum weight off 1), exact / bf16 / int8 wires, one and two
  peers per round: the ps-weight and the parameters bit-equal to the
  reference after every round (the same float32 ops in the same order).
* World 2 over gloo, two processes: the ``DistTransport`` rounds give
  the stacked lane's values bit for bit.  Each process is joined with a
  timeout, so a hang fails the test instead of stalling the suite.
"""

import os
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw
from stochastic_gradient_push_torch import topology as tt
from torch_launch import spawn

torch.set_num_threads(1)

WORLD = 8
ROUNDS = 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(world, seed=0):
    r = np.random.default_rng(seed)
    params = {"w": r.standard_normal((world, 6, 50)).astype(np.float32),
              "b": r.standard_normal((world, 130)).astype(np.float32),
              "one": r.standard_normal((world, 1)).astype(np.float32)}
    ps = (1.0 + r.random(world)).astype(np.float32)
    return params, ps


def _schedules(mod, world, ppi, mixing):
    graph = mod.NPeerDynamicDirectedExponentialGraph(world, peers_per_itr=ppi)
    mix = (mod.SelfWeightedMixing(np.linspace(0.3, 0.7, world))
           if mixing == "self" else mod.UniformMixing())
    return mod.build_schedule(graph, mix)


def _codec(mod, name):
    return None if name == "none" else mod.get_codec(name, 16)


@pytest.mark.parametrize("wire", ["none", "f32", "bf16", "int8"])
@pytest.mark.parametrize("mixing", ["uniform", "self"])
@pytest.mark.parametrize("ppi", [1, 2])
def test_world8_rounds_bit_equal_reference(wire, mixing, ppi):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_tpu import topology as rt
    from stochastic_gradient_push_tpu.parallel import wire as rw
    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_sum)
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)

    params, ps = _state(WORLD, seed=ppi)
    jsched = _schedules(rt, WORLD, ppi, mixing)
    tsched = _schedules(tt, WORLD, ppi, mixing)
    jcodec, tcodec = _codec(rw, wire), _codec(tw, wire)
    mesh = make_gossip_mesh(WORLD)

    def jround(phase):
        def body(p, w):
            return mix_push_sum(p, w, jnp.int32(phase), jsched, GOSSIP_AXIS,
                                codec=jcodec)
        return jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P(GOSSIP_AXIS), P(GOSSIP_AXIS)),
            out_specs=(P(GOSSIP_AXIS), P(GOSSIP_AXIS))))

    jp, jw = params, ps
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    tw_ = torch.from_numpy(ps.copy())
    transport = tc.StackedTransport(WORLD)
    for phase in range(ROUNDS):
        jp, jw = jax.device_get(jround(phase)(jp, jw))
        tp, tw_ = tc.mix_push_sum(tp, tw_, phase, tsched, transport,
                                  codec=tcodec)
        np.testing.assert_array_equal(tw_.numpy(), np.asarray(jw))
        for n in params:
            np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]),
                                          err_msg=f"{n} phase {phase}")
    # push-sum mass is conserved (up to the order of this float sum)
    np.testing.assert_allclose(tw_.sum().numpy(), ps.sum(), rtol=1e-6)


def test_round_at_world_one_returns_its_input():
    params, ps = _state(1)
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(1))
    out, w = tc.mix_push_sum(tp, torch.from_numpy(ps), 3, sched,
                             tc.StackedTransport(1))
    assert all(out[n] is tp[n] for n in tp)
    np.testing.assert_array_equal(w.numpy(), ps)


def test_schedule_world_must_match_transport():
    params, ps = _state(4)
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(8))
    with pytest.raises(ValueError, match="world_size=8"):
        tc.mix_push_sum({n: torch.from_numpy(a) for n, a in params.items()},
                        torch.from_numpy(ps), 0, sched,
                        tc.StackedTransport(4))


def test_allreduce_mean_is_the_rank_mean():
    params, _ = _state(4)
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    out = tc.allreduce_mean(tp, tc.StackedTransport(4))
    for n, a in params.items():
        np.testing.assert_allclose(out[n].numpy(),
                                   np.broadcast_to(a.mean(0), a.shape),
                                   rtol=1e-6, atol=1e-7)


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw
from stochastic_gradient_push_torch import topology as tt
rank, port, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
data = np.load(sys.argv[5])
params = {n: torch.from_numpy(data[n][rank:rank + 1].copy())
          for n in ("w", "b", "one")}
ps = torch.from_numpy(data["ps"][rank:rank + 1].copy())
sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(2),
                          tt.SelfWeightedMixing(np.array([0.3, 0.6])))
transport = tc.DistTransport()
for phase in range(4):
    params, ps = tc.mix_push_sum(params, ps, phase, sched, transport,
                                 codec=tw.Int8Codec(16))
mean = tc.allreduce_mean(params, transport)
np.savez(out, ps=ps.numpy(), **{n: p.numpy() for n, p in params.items()},
         **{"mean_" + n: p.numpy() for n, p in mean.items()})
dist.destroy_process_group()
"""


def test_dist_lane_equals_stacked_lane_over_gloo(tmp_path):
    params, ps = _state(2, seed=7)
    data = tmp_path / "state.npz"
    np.savez(data, ps=ps, **params)
    spawn(2, lambda r, port: [
        sys.executable, "-c", _WORKER, REPO, str(r), str(port),
        str(tmp_path / f"rank{r}.npz"), str(data)], timeout=120,
        PYTHONPATH=REPO)

    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(2),
                              tt.SelfWeightedMixing(np.array([0.3, 0.6])))
    transport = tc.StackedTransport(2)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    tw_ = torch.from_numpy(ps.copy())
    for phase in range(4):
        tp, tw_ = tc.mix_push_sum(tp, tw_, phase, sched, transport,
                                  codec=tw.Int8Codec(16))
    mean = tc.allreduce_mean(tp, transport)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(got["ps"], tw_.numpy()[r:r + 1])
        for n in params:
            np.testing.assert_array_equal(got[n], tp[n].numpy()[r:r + 1])
            np.testing.assert_array_equal(got["mean_" + n],
                                          mean[n].numpy()[r:r + 1])


@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
@pytest.mark.parametrize("ppi", [1, 2])
def test_overlap_halves_sum_to_the_round(wire, ppi):
    """``overlap_launch``'s local and incoming shares add up to
    ``gossip_round`` within one rounding (the round fuses the local
    share into its first add; the split rounds it on its own), landed at
    once (staleness 1) or settled first (later slots).  On the kernel
    lane a share landed at once is the synchronous round bit for bit on
    every payload leaf: both round the local share alone and fold the
    same edges in the same order."""
    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane

    params, ps = _state(WORLD, seed=11)
    tree = [torch.from_numpy(params[n]) for n in ("w", "b", "one")]
    tree.append(torch.from_numpy(ps))
    sched = _schedules(tt, WORLD, ppi, "self")
    transport = tc.StackedTransport(WORLD)
    codec = _codec(tw, wire)
    lane = KernelLane(interpret=True, chunk_elems=128)
    for phase in range(3):
        for kernel in (None, lane):
            kw = dict(codec=codec, kernel=kernel, buckets=2)
            full = tc.gossip_round(tree, phase, sched, transport, **kw)
            local, inc = tc.overlap_launch(tree, phase, sched, transport,
                                           **kw)
            assert isinstance(inc, tc.PendingShares) == (kernel is not None)
            landed = tc.land_shares(local, inc)
            settled = tc.land_shares(local, tc.settle_share(inc))
            for j, (a, b, c) in enumerate(zip(landed, settled, full)):
                if kernel is not None and c[0].numel() > 1:
                    assert torch.equal(a, c)
                assert float((a - c).abs().max()) <= 1e-6
                assert float((b - c).abs().max()) <= 1e-6
        tree = full


def test_overlap_round_at_world_one_has_a_zero_incoming_share():
    params, ps = _state(1)
    tree = [torch.from_numpy(params["w"]), torch.from_numpy(ps)]
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(1))
    local, inc = tc.overlap_launch(tree, 0, sched, tc.StackedTransport(1))
    assert all(a is b for a, b in zip(local, tree))
    assert all(not t.any() for t in inc)
