"""Port parity: the cross-process gossip transport
(``stochastic_gradient_push_torch.ops.gossip_kernel.gossip_edge_start_dist``
over ``collectives.DistTransport``) on the CPU, where its plain twin
carries the encoded parts over gloo ``batch_isend_irecv`` into each
receiver's landing rows and lands them with the K1 twin.

* World 2 and 4, gloo processes, four rounds from one numpy state: SGP
  (sync) and OSGP (staleness 1 and 2) on the f32, bf16 and int8 wires,
  two transport buckets, self-weighted mixing with one peer and uniform
  mixing with two (world 4).  Each process's rank row is bit-equal to
  the stacked kernel lane's (``KernelLane(interpret=True)`` on a
  ``StackedTransport``), ps-weight and parameters, after every round.
  Against the reference's compiled round (``jax.jit`` of ``shard_map``,
  its XLA lane) the ps-weight is bit-equal and the parameters are held
  to ``PARAM_ATOL`` = 1e-6, the stacked kernel lane's own bound
  (``tests/test_torch_gossip_kernel.py``: the kernel lane rounds the
  local share on its own where XLA fuses it into an FMA).
* A peer that never sends: the receiver raises ``PeerLostError`` naming
  its rank, the edge, the round and the peer within its limit, and
  does not hang.
* A ``DistTransport`` at world 17 (torch's fake backend, one process)
  runs plain and twin rounds: nothing caps the world.
* The C entry points of ``csrc/gossip_edge.cu`` take as many arguments as
  their ``ctypes`` argtypes in ``ops/_build.py`` say (the card is the
  only place a mismatch would otherwise show).

Every child process runs under its own ``communicate(timeout=...)``
with one torch thread, so a hang fails the test instead of stalling the
suite.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.ops import _build
from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 4
PARAM_ATOL = 1e-6
WIRES = ("f32", "bf16", "int8")
MODES = {"sync": (False, 1), "overlap1": (True, 1), "overlap2": (True, 2)}
CHUNK = 128
BUCKETS = 2


def _state(world, seed=3):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((world, 6, 50)).astype(np.float32),
            "b": r.standard_normal((world, 130)).astype(np.float32)}


def _ppi_mixing(world):
    return (2, "uniform") if world == 4 else (1, "self")


def _mixing(mod, mixing, world):
    return (mod.SelfWeightedMixing(np.linspace(0.3, 0.7, world))
            if mixing == "self" else mod.UniformMixing())


_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw

rank, world, port, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], \
    sys.argv[5]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
state = np.load(sys.argv[6])
ppi, mixing = (2, "uniform") if world == 4 else (1, "self")
mix = (tt.SelfWeightedMixing(np.linspace(0.3, 0.7, world))
       if mixing == "self" else tt.UniformMixing())
sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(
    world, peers_per_itr=ppi), mix)
transport = tc.DistTransport(timeout_s=120.0)
lane = tgk.KernelLane(interpret=True, chunk_elems=%(chunk)d)
results = {}
for wire in %(wires)r:
    for mode, (overlap, staleness) in %(modes)r.items():
        alg = talg.sgp(sched, transport, wire=tw.get_codec(wire, 16),
                       overlap=overlap, staleness=staleness,
                       gossip_kernel=lane, gossip_buckets=%(buckets)d)
        params = {k: torch.from_numpy(v[rank:rank + 1].copy())
                  for k, v in state.items()}
        gstate = alg.init(params)
        for t in range(%(rounds)d):
            params, gstate = alg.pre_step(params, gstate)
            params, gstate = alg.post_step(params, gstate)
            results[f"{wire}/{mode}/{t}/ps"] = gstate.ps_weight.numpy()
            for k, v in params.items():
                results[f"{wire}/{mode}/{t}/{k}"] = v.numpy()
np.savez(out, **results)
dist.barrier()
dist.destroy_process_group()
""" % dict(chunk=CHUNK, wires=WIRES, modes=MODES, buckets=BUCKETS,
           rounds=ROUNDS)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(script, world, args, timeout=240):
    """Run ``script`` in ``world`` processes (argv: repo, rank, world,
    port, *args(rank)); returns their logs, raising on a nonzero exit."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, REPO, str(r), str(world), str(port),
         *args(r)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def dist_rounds(request, tmp_path_factory):
    """Every (wire, mode) of the cross-process twin at one world, run
    once: ``(world, {key: [rank rows]})``."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"dist{world}")
    data = tmp / "state.npz"
    np.savez(data, **_state(world))
    rcs, logs = _spawn(_WORKER, world, lambda r: [str(tmp / f"r{r}.npz"),
                                                  str(data)])
    assert rcs == [0] * world, "\n".join(logs)
    ranks = [np.load(tmp / f"r{r}.npz") for r in range(world)]
    return world, {k: np.concatenate([z[k] for z in ranks])
                   for k in ranks[0].files}


def _stacked_rounds(world, wire, mode):
    overlap, staleness = MODES[mode]
    ppi, mixing = _ppi_mixing(world)
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(
        world, peers_per_itr=ppi), _mixing(tt, mixing, world))
    alg = talg.sgp(sched, tc.StackedTransport(world),
                   wire=tw.get_codec(wire, 16), overlap=overlap,
                   staleness=staleness,
                   gossip_kernel=tgk.KernelLane(interpret=True,
                                                chunk_elems=CHUNK),
                   gossip_buckets=BUCKETS)
    params = {k: torch.from_numpy(v.copy())
              for k, v in _state(world).items()}
    gstate = alg.init(params)
    out = []
    for _ in range(ROUNDS):
        params, gstate = alg.pre_step(params, gstate)
        params, gstate = alg.post_step(params, gstate)
        out.append({"ps": gstate.ps_weight.numpy().copy(),
                    **{k: v.numpy().copy() for k, v in params.items()}})
    return out


def _reference_rounds(world, wire, mode):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_tpu import topology as rt
    from stochastic_gradient_push_tpu.algorithms import sgp
    from stochastic_gradient_push_tpu.parallel import wire as rw
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)

    overlap, staleness = MODES[mode]
    ppi, mixing = _ppi_mixing(world)
    sched = rt.build_schedule(rt.NPeerDynamicDirectedExponentialGraph(
        world, peers_per_itr=ppi), _mixing(rt, mixing, world))
    alg = sgp(sched, GOSSIP_AXIS, wire=rw.get_codec(wire, 16),
              overlap=overlap, staleness=staleness)

    def step(p, g):
        p, g = alg.pre_step(p, g)
        return alg.post_step(p, g)

    fn = jax.jit(jax.shard_map(step, mesh=make_gossip_mesh(world),
                               in_specs=(P(GOSSIP_AXIS),) * 2,
                               out_specs=(P(GOSSIP_AXIS),) * 2))
    params = _state(world)
    gstate = alg.init(jax.tree.map(lambda a: jnp.zeros(a.shape[1:], a.dtype),
                                   params))
    gstate = jax.tree.map(lambda a: np.broadcast_to(
        np.asarray(a), (world,) + np.shape(a)).copy(), gstate)
    out = []
    for _ in range(ROUNDS):
        params, gstate = jax.block_until_ready(fn(params, gstate))
        out.append({"ps": np.asarray(gstate.ps_weight).copy(),
                    **{k: np.asarray(v).copy() for k, v in params.items()}})
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("wire", WIRES)
def test_dist_twin_equals_stacked_kernel_lane_and_reference(dist_rounds,
                                                            wire, mode):
    world, got = dist_rounds
    stacked = _stacked_rounds(world, wire, mode)
    ref = _reference_rounds(world, wire, mode)
    for t in range(ROUNDS):
        for k in stacked[t]:
            mine = got[f"{wire}/{mode}/{t}/{k}"]
            np.testing.assert_array_equal(
                mine, stacked[t][k], err_msg=f"{k} round {t} vs stacked")
            if k == "ps":
                np.testing.assert_array_equal(
                    mine, ref[t][k], err_msg=f"ps round {t} vs reference")
            else:
                np.testing.assert_allclose(
                    mine, ref[t][k], rtol=0, atol=PARAM_ATOL,
                    err_msg=f"{k} round {t} vs reference")


_SILENT = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw

rank, world, port = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
store = tgk.PeerLinks.store()
transport = tc.DistTransport(timeout_s=float(sys.argv[5]))
if rank == 0:
    parts = (torch.ones(1, 1, 300),)
    t0 = time.perf_counter()
    try:
        handle = transport.edge_start(parts, [[1, 0]],
                                      tw.F32.kernel_spec(), 300,
                                      tgk.KernelLane(interpret=True))
        tgk.gossip_edge_wait(handle, torch.zeros(1, 300))
        print("no error", flush=True)
    except tgk.PeerLostError as e:
        print(f"raised after {time.perf_counter() - t0:.1f} s: {e}",
              flush=True)
    store.set("done", "1")
    store.wait(["ack"])    # rank 0 serves the store: the last to leave
else:
    store.wait(["done"])   # a live peer that never sends
    store.set("ack", "1")
import os
os._exit(0)
"""


def test_peer_that_never_sends_raises_naming_rank_edge_round():
    rcs, logs = _spawn(_SILENT, 2, lambda r: ["2.0"], timeout=120)
    assert rcs == [0, 0], "\n".join(logs)
    m = re.search(r"raised after ([0-9.]+) s: (.*)", logs[0])
    assert m, logs[0]
    assert float(m.group(1)) < 30.0
    assert re.search(r"rank 0, edge 0, round 1: .*rank 1", m.group(2)), \
        m.group(2)


def _c_params(src: str):
    """``{entry point: parameter count}`` of the ``extern "C"`` functions
    of a CUDA source."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[m.group(1)] = len([a for a in m.group(2).split(",")
                               if a.strip()])
    return out


@pytest.mark.parametrize("name", sorted(_build.KERNELS["gossip_edge"]))
def test_entry_point_arity_matches_its_argtypes(name):
    src = (_build.CSRC / "gossip_edge.cu").read_text()
    assert _c_params(src)[name] == len(_build.KERNELS["gossip_edge"][name])


def test_cross_process_start_checks_its_inputs():
    class Links:   # never reached: the checks come first
        world, rank = 2, 0

    spec = tw.F32.kernel_spec()
    with pytest.raises(ValueError, match=r"\(1, 1\) rows"):
        tgk.gossip_edge_start_dist((torch.ones(2, 1, 8),), [[1, 0]], spec,
                                   Links())
    with pytest.raises(ValueError, match="permutation"):
        tgk.gossip_edge_start_dist((torch.ones(1, 1, 8),), [[0, 0]], spec,
                                   Links())
    with pytest.raises(tgk.KernelLaneError, match="CUDA tensors only"):
        tgk.gossip_edge_start_dist((torch.ones(1, 1, 8),), [[1, 0]], spec,
                                   Links(), interpret=False)
    links = tgk.PeerLinks(0, 17)   # no cap on the world: nothing mapped
    assert (links.world, links.links) == (17, {})


def test_dist_transport_runs_a_world_of_17():
    """A ``DistTransport`` of a world larger than 16 ranks builds, runs a
    plain-lane round and a kernel-lane (twin) round, and makes its
    ``PeerLinks`` only at the kernel lane's first start.  One process
    stands for rank 3 of 17 on torch's fake backend, whose sends and
    receives move nothing, so only the flow is checked, not values."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 17
    dist.init_process_group("fake", rank=3, world_size=world,
                            store=FakeStore())
    try:
        transport = tc.DistTransport()
        assert transport.links is None
        sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(
            world, peers_per_itr=2), tt.UniformMixing())
        params = {k: torch.from_numpy(v[3:4].copy())
                  for k, v in _state(world).items()}
        ps = torch.ones(1)
        for phase in range(2):
            params, ps = tc.mix_push_sum(params, ps, phase, sched,
                                         transport, codec=tw.Int8Codec(16))
        assert transport.links is None
        alg = talg.sgp(sched, transport, wire=tw.get_codec("bf16", 16),
                       gossip_kernel=tgk.KernelLane(interpret=True,
                                                    chunk_elems=CHUNK))
        gstate = alg.init(params)
        params, gstate = alg.pre_step(params, gstate)
        params, gstate = alg.post_step(params, gstate)
        assert isinstance(transport.links, tgk.PeerLinks)
        assert transport.links.world == world
        assert params["w"].shape == (1, 6, 50)
        transport.check()
    finally:
        dist.destroy_process_group()


_LM_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1] + "/tests")
from test_torch_gossip_kernel_dist import lm_run
from stochastic_gradient_push_torch.parallel import collectives as tc

rank, world, port, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], \
    sys.argv[5]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
np.savez(out, **lm_run(tc.DistTransport(timeout_s=120.0), world))
dist.barrier()
dist.destroy_process_group()
"""

LM_STEPS = 3


def lm_run(transport, world):
    """Three LM steps (SGP on the int8 wire, the kernel lane's twins) on
    the rows ``transport`` holds; ``{name: rows}`` of the final params,
    the ps-weight and every step's loss."""
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.train import lm as tlm
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd

    cfg = TransformerConfig(vocab_size=64, d_model=16, n_layers=1,
                            n_heads=1, d_ff=32, attn_impl="flash")
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(world))
    alg = talg.sgp(sched, transport, wire=tw.get_codec("int8", 16),
                   gossip_kernel=tgk.KernelLane(interpret=True,
                                                chunk_elems=CHUNK),
                   gossip_buckets=BUCKETS)
    tx = sgd(0.9, 0.0)
    step = tlm.build_lm_train_step(tlm.make_model(cfg), alg, tx,
                                   LRSchedule(0.5, 2, world, {}), 10)
    rows = np.asarray(transport.ranks)
    state = tlm.init_lm_state(cfg, alg, tx, len(rows), seed=5)
    r = np.random.default_rng(9)
    losses = []
    for _ in range(LM_STEPS):
        toks = r.integers(0, 64, (world, 2, 17))
        state, m = step(state, torch.from_numpy(toks[rows, :, :-1]),
                        torch.from_numpy(toks[rows, :, 1:]))
        losses.append(m["loss"].detach().numpy())
    return {"ps": state.gossip.ps_weight.numpy(), "loss": np.stack(losses, 1),
            **{k: v.detach().numpy() for k, v in state.params.items()}}


def test_lm_step_on_the_dist_twin_equals_the_stacked_kernel_lane(tmp_path):
    """The LM CLI's kernel lane under torchrun, on the CPU: three SGP
    steps with the cross-process twin over gloo give each rank the
    stacked kernel lane's state."""
    rcs, logs = _spawn(_LM_WORKER, 2, lambda r: [str(tmp_path / f"r{r}.npz")])
    assert rcs == [0, 0], "\n".join(logs)
    want = lm_run(tc.StackedTransport(2), 2)
    got = [np.load(tmp_path / f"r{r}.npz") for r in range(2)]
    for k, v in want.items():
        np.testing.assert_array_equal(np.concatenate([g[k] for g in got]), v,
                                      err_msg=k)
